"""The port's quantizers and weight-only matmul against the JAX package's,
on the CPU.

Payloads must be equal byte for byte (both frameworks divide in IEEE f32 and
round half to even). Scales are compared decoded at rtol 1e-6: XLA may
lower amax / 127 one ulp away from the IEEE quotient
(tests/test_paged_fused.py:242-252). The matmul's plain version is held to
JAX's `quantized_matmul` and to `quantized_matmul_pallas` in interpret mode
at the dtype gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.ops import quant as JQ
from tiny_flash_attention_tpu.ops.quant_matmul import quantized_matmul_pallas
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.ops import quant as TQ
from tiny_flash_attention_tpu_torch.ops import quant_matmul as TQM
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _payload(x) -> np.ndarray:
    """A payload's bytes (int8 or float8_e4m3fn) as uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _assert_same(tq, jq):
    assert tuple(tq.values.shape) == jq.values.shape
    assert tuple(tq.scales.shape) == jq.scales.shape
    np.testing.assert_array_equal(_payload(tq.values), _payload(jq.values))
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               rtol=1e-6, atol=0)


def _data(shape, seed, dtype=torch.float32, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a *= np.float32(scale)
    a[0, :3] = 0.0          # a few zeros, and below a row of all zeros
    a[-1] = 0.0
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy(), _JNP[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kw", [{}, {"axis": 0}, {"axis": (0, 1)},
                                {"block": 32}, {"axis": 0, "block": 16}],
                         ids=["row", "col", "tensor", "block32", "colblock16"])
def test_quantize_int8_matches_jax(dtype, kw):
    t, j = _data((48, 128), 0, dtype)
    _assert_same(TQ.quantize_int8(t, **kw), JQ.quantize_int8(j, **kw))


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_fp8_matches_jax(axis):
    t, j = _data((48, 128), 1)
    got, want = TQ.quantize_fp8(t, axis=axis), JQ.quantize_fp8(j, axis=axis)
    assert got.values.dtype == torch.float8_e4m3fn
    _assert_same(got, want)
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_weight_and_kv_match_jax(fmt):
    w, jw = _data((64, 96), 2)
    _assert_same(TQ.quantize_weight(w, fmt), JQ.quantize_weight(jw, fmt))
    k, jk = _data((2, 4, 32, 64), 3)
    v, jv = _data((2, 4, 32, 64), 4)
    for got, want in zip(TQ.quantize_kv(k, v, fmt), JQ.quantize_kv(jk, jv,
                                                                    fmt)):
        _assert_same(got, want)


def test_quantize_int8_block_must_divide():
    with pytest.raises(ValueError, match="block"):
        TQ.quantize_int8(torch.zeros((4, 30)), block=16)


def _jax_params(dtype=jnp.float32):
    cfg = JT.ModelConfig(vocab_size=128, d_model=64, n_layers=2, n_q_heads=2,
                         n_kv_heads=1, d_head=64, d_ff=96, dtype=dtype)
    return JT.init_params(cfg, jax.random.key(0))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_params_matches_jax(fmt):
    """The port's quantize_params on the carried-over weights equals JAX's
    quantize_params carried over (stacked (L, K, N) values and (L, 1, N)
    scales split per layer), byte for byte."""
    jp = _jax_params()
    want = TT.params_from_jax(jax.tree.map(np.asarray,
                                           JT.quantize_params(jp, fmt)),
                              device="cpu")
    got = TT.quantize_params(TT.params_from_jax(jax.tree.map(np.asarray, jp),
                                                device="cpu"), fmt)
    assert isinstance(got["lm_head"], TQ.QuantizedTensor)
    assert isinstance(want["lm_head"], TQ.QuantizedTensor)
    _assert_same(got["lm_head"], want["lm_head"])
    for g_layer, w_layer in zip(got["layers"], want["layers"]):
        assert g_layer.keys() == w_layer.keys()
        for name in g_layer:
            g, w = g_layer[name], w_layer[name]
            if name in ("attn_norm", "mlp_norm"):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
                continue
            assert w.scales.shape == (1, w.values.shape[1])
            np.testing.assert_array_equal(_payload(g.values),
                                          _payload(w.values))
            np.testing.assert_allclose(g.scales.numpy(), w.scales.numpy(),
                                       rtol=1e-6, atol=0)
    torch.testing.assert_close(got["embed"], want["embed"], rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("m", [1, 3, 8])
def test_quantized_matmul_plain_matches_jax(fmt, dtype, m):
    """Against XLA's quantized_matmul and the Pallas kernel in interpret
    mode, at the dtype gates (f32 2e-5, bf16 2e-2). x is scaled by
    1/sqrt(K), so the outputs are of order one, as the gates assume."""
    x, jx = _data((m, 256), 5 + m, dtype, scale=1 / 16)
    w, jw = _data((256, 384), 6)
    qw, jqw = TQ.quantize_weight(w, fmt), JQ.quantize_weight(jw, fmt)
    got = TQM.quantized_matmul_plain(x, qw)
    assert got.dtype == dtype and got.shape == (m, 384)
    atol = tolerance_for(dtype)
    for want in (JQ.quantized_matmul(jx, jqw),
                 quantized_matmul_pallas(jx, jqw, block_n=128, block_k=128,
                                         interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=atol, rtol=0)
    # the public route takes the plain version on a CPU tensor
    routed = TQ.quantized_matmul(x, qw)
    torch.testing.assert_close(routed, got, rtol=0, atol=0)


def test_quantized_matmul_keeps_leading_dims_and_out_dtype():
    x, jx = _data((2, 3, 64), 7)
    w, jw = _data((64, 40), 8)
    got = TQ.quantized_matmul(x, TQ.quantize_weight(w),
                              out_dtype=torch.bfloat16)
    want = JQ.quantized_matmul(jx, JQ.quantize_weight(jw),
                               out_dtype=jnp.bfloat16)
    assert got.shape == (2, 3, 40) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_cpu_quantized_matmul_launches_no_kernel():
    TQM.quantized_matmul_cuda.launches = 0
    x, _ = _data((8, 64), 9, torch.bfloat16)
    TQ.quantized_matmul(x, TQ.quantize_weight(_data((64, 32), 10)[0]))
    assert TQM.quantized_matmul_cuda.launches == 0


def test_quantized_matmul_cuda_refuses_what_it_does_not_take():
    """The kernel's wrapper checks its inputs before it builds anything."""
    w = TQ.quantize_weight(_data((64, 32), 11)[0])
    with pytest.raises(NotImplementedError, match="rows"):
        TQM.quantized_matmul_cuda(torch.zeros((17, 64)), w)
    with pytest.raises(NotImplementedError, match="dtype"):
        TQM.quantized_matmul_cuda(torch.zeros((2, 64), dtype=torch.float16),
                                  w)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        TQM.quantized_matmul_cuda(
            torch.zeros((2, 64)),
            TQ.quantize_weight(_data((64, 30), 12)[0]))
    with pytest.raises(ValueError):
        TQM.quantized_matmul_cuda(torch.zeros((2, 60)), w)
