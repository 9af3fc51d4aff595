"""The port's `flash_attention_quantized` against the JAX package's, on the CPU.

Both packages get the same payload bytes and scales: JAX's quantizer makes
them and `models/transformer.py::quantized_from_jax` hands them to the port
(int8 as it is, e4m3 through a uint8 view). JAX runs its Pallas kernels in
interpret mode (`FlashConfig(block_q=128, block_kv=128, interpret=True)`,
or `default_config`, whose `kernel="auto"` takes the triangle kernel for
causal 1024 x 1024); the port runs its plain version, the kernel's rounding
points in one pass. Gates: the dtype gates of the JAX package (f32 2e-5,
bf16 2e-2) on out and on the LSE. The cases are tests/test_quant.py's
(int8 and fp8, causal or not, the bf16 GQA decode, the window, packed
segments) and tests/test_fuzz.py's seven `CASES`, head_dim 80 and q_len >
kv_len included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tiny_flash_attention_tpu.ops import quant as JQ
from tiny_flash_attention_tpu.ops.configs import FlashConfig
from tiny_flash_attention_tpu.ops.flash import _payload_to_compute
from tiny_flash_attention_tpu.ops.flash_quant import (
    flash_attention_quantized as jax_flash_quantized)
from tiny_flash_attention_tpu_torch.models.transformer import (
    quantized_from_jax)
from tiny_flash_attention_tpu_torch.ops.flash_quant import (
    flash_attention_quantized, payload_to_compute)
from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

INTERP = FlashConfig(block_q=128, block_kv=128, interpret=True)
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _q(rng, shape, dtype):
    """q for both packages: the same values in `dtype`."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(dtype)
    return t, jnp.asarray(t.float().numpy(), _JNP[dtype])


def _kv(rng, shape, fmt):
    """K and V quantized by JAX, and the same bytes as the port's."""
    k = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    jk, jv = JQ.quantize_kv(k, v, fmt)
    return (jk, jv), tuple(quantized_from_jax(jax.tree.map(np.asarray, t),
                                              device="cpu")
                           for t in (jk, jv))


def _err(got, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.max(np.abs(got.float().numpy() - want)))


def _compare(q_shape, kv_shape, fmt, dtype, *, seed=0, config=INTERP,
             segs=None, return_lse=False, **kw):
    rng = np.random.default_rng(seed)
    tq, jq = _q(rng, q_shape, dtype)
    (jk, jv), (tk, tv) = _kv(rng, kv_shape, fmt)
    jsegs = tsegs = None
    if segs is not None:
        jsegs = tuple(jnp.asarray(s) for s in segs)
        tsegs = tuple(torch.from_numpy(np.asarray(s)) for s in segs)
    want = jax_flash_quantized(jq, jk, jv, config=config, segment_ids=jsegs,
                               return_lse=return_lse, **kw)
    got = flash_attention_quantized(tq, tk, tv, segment_ids=tsegs,
                                    return_lse=return_lse, **kw)
    atol = tolerance_for(dtype)
    if return_lse:
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        assert _err(got[0], want[0]) <= atol
        assert _err(got[1], want[1]) <= atol
    else:
        assert got.dtype == dtype and tuple(got.shape) == q_shape
        assert _err(got, want) <= atol


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_fused_dequant_attention_matches_jax(fmt, causal):
    """tests/test_quant.py::test_fused_dequant_attention's shape."""
    _compare((1, 4, 256, 64), (1, 4, 256, 64), fmt, torch.float32, seed=5,
             causal=causal)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_bf16_gqa_decode_matches_jax(fmt):
    """One bf16 decode row of 8 q heads over 2 kv heads of 512 tokens."""
    _compare((2, 8, 1, 64), (2, 2, 512, 64), fmt, torch.bfloat16, seed=6,
             causal=True)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_sliding_window_matches_jax(fmt):
    _compare((1, 2, 512, 64), (1, 2, 512, 64), fmt, torch.float32, seed=8,
             causal=True, window=128)


@pytest.mark.parametrize("starts", [None, (0, 200)], ids=["ids", "starts"])
def test_packed_segments_match_jax(starts):
    """Two packed segments; the static starts prune JAX's work list and
    change no result."""
    seg = np.asarray([[1] * 200 + [2] * 184], np.int32)
    _compare((1, 2, 384, 64), (1, 2, 384, 64), "int8", torch.float32,
             seed=9, causal=True, segs=(seg, seg), segment_starts=starts)


# tests/test_fuzz.py:56-64 (seed, bs, hq, hkv, q_len, kv_len, d, causal,
# window, with_segments)
FUZZ_CASES = [
    (0, 1, 2, 2, 256, 256, 64, True, None, False),
    (1, 2, 4, 2, 200, 520, 64, True, None, False),
    (2, 1, 2, 1, 384, 384, 80, True, 150, False),
    (3, 1, 3, 3, 300, 300, 64, True, None, True),
    (4, 1, 4, 2, 130, 640, 128, True, 200, True),
    (5, 1, 2, 2, 256, 512, 64, False, None, True),
    (6, 1, 2, 2, 640, 384, 64, True, None, False),
]


def _fuzz_segments(seed, bs, q_len, kv_len):
    """tests/test_fuzz.py::_make's ids: nondecreasing over the kv axis, q
    sharing the kv suffix (or padding its front)."""
    rng = np.random.default_rng(seed)
    bounds = np.sort(rng.choice(np.arange(1, kv_len), 3, replace=False))
    kv_seg = np.searchsorted(bounds, np.arange(kv_len), side="right")
    kv_seg = np.tile(kv_seg[None], (bs, 1)).astype(np.int32)
    q_seg = kv_seg[:, kv_len - q_len:] if q_len <= kv_len else \
        np.pad(kv_seg, ((0, 0), (q_len - kv_len, 0)), mode="edge")
    return q_seg, kv_seg


@pytest.mark.parametrize("case", FUZZ_CASES, ids=lambda c: f"seed{c[0]}")
def test_fuzz_cases_match_jax(case):
    seed, bs, hq, hkv, q_len, kv_len, d, causal, window, with_seg = case
    segs = _fuzz_segments(seed, bs, q_len, kv_len) if with_seg else None
    _compare((bs, hq, q_len, d), (bs, hkv, kv_len, d), "int8",
             torch.float32, seed=seed, causal=causal, window=window,
             segs=segs)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_triangle_regime_matches_jax(fmt):
    """Causal 1024 x 1024 under JAX's default config (kernel="auto"), which
    takes the one-shot triangle kernel: the port's one launch computes what
    B1 and B2 both compute."""
    _compare((1, 4, 1024, 64), (1, 2, 1024, 64), fmt, torch.bfloat16,
             seed=11, config=None, causal=True)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_return_lse_matches_jax(fmt):
    """out and the natural-log LSE, with rows before every kv position
    (q_len > kv_len): out 0 and the sentinel (mask value) * ln2."""
    _compare((1, 4, 320, 64), (1, 2, 192, 64), fmt, torch.float32, seed=12,
             causal=True, return_lse=True)


def _jax_payload_bf16(codes: np.ndarray) -> np.ndarray:
    """JAX's own `_payload_to_compute` to bf16, inside a pallas_call in
    interpret mode (its bitcast runs only in a kernel)."""
    x = jnp.asarray(codes.view(jnp.float8_e4m3fn))

    def kernel(x_ref, o_ref):
        o_ref[...] = _payload_to_compute(x_ref[...], jnp.bfloat16)
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
        interpret=True)(x)
    return np.asarray(out.astype(jnp.float32))


def test_e4m3_to_bf16_is_jaxs_mapping():
    """All 256 e4m3 codes: bit for bit JAX's mapping, which differs from the
    exact convert at the subnormal codes (they land high) and the NaN codes
    (+/-480)."""
    codes = np.arange(256, dtype=np.uint8).reshape(2, 128)
    got = payload_to_compute(
        torch.from_numpy(codes).view(torch.float8_e4m3fn), torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  _jax_payload_bf16(codes))
    exact = torch.from_numpy(codes).view(torch.float8_e4m3fn).float()
    differ = ~((got.float() == exact) | torch.isnan(exact))
    subnormal = [c for c in range(256) if c & 0x78 == 0 and c & 0x07]
    assert sorted(differ.flatten().nonzero().flatten().tolist()) == subnormal
    assert got.flatten()[0x7F].item() == 480.0
    assert got.flatten()[0xFF].item() == -480.0


def test_bf16_fp8_codes_match_jax_not_the_exact_convert():
    """A bf16-q fp8 cache whose V payload holds the subnormal codes
    0x01-0x07 and the NaN codes 0x7F/0xFF at scale 1, K all zero (every
    column weighs the same): the port's output is JAX's, bit for bit on
    those columns, and not what the exact convert would give."""
    b, hq, hkv, n, d = 1, 2, 1, 128, 64
    rng = np.random.default_rng(13)
    tq, jq = _q(rng, (b, hq, n, d), torch.bfloat16)
    k_codes = np.zeros((b, hkv, n, d), np.uint8)
    v_codes = rng.integers(0x08, 0x70, (b, hkv, n, d)).astype(np.uint8)
    special = [0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x7F, 0xFF]
    v_codes[..., :len(special)] = special
    ones = np.ones((b, hkv, n, 1), np.float32)
    jk = JQ.QuantizedTensor(jnp.asarray(k_codes.view(jnp.float8_e4m3fn)),
                            jnp.asarray(ones))
    jv = JQ.QuantizedTensor(jnp.asarray(v_codes.view(jnp.float8_e4m3fn)),
                            jnp.asarray(ones))
    tk, tv = (quantized_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in (jk, jv))
    want = np.asarray(jax_flash_quantized(jq, jk, jv, causal=False,
                                          config=INTERP).astype(jnp.float32))
    got = flash_attention_quantized(tq, tk, tv, causal=False).float().numpy()
    assert np.max(np.abs(got - want)) <= tolerance_for(torch.bfloat16)
    cols = slice(0, len(special))
    np.testing.assert_array_equal(got[..., cols], want[..., cols])
    mapped = payload_to_compute(
        torch.tensor(special, dtype=torch.uint8).view(torch.float8_e4m3fn),
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[..., cols],
                                  np.broadcast_to(mapped, got[..., cols].shape))
    exact = torch.tensor(special, dtype=torch.uint8).view(
        torch.float8_e4m3fn).float().numpy()
    assert (mapped[:7] > exact[:7]).all()          # 0x01: 2^-9 exact
    assert not (got[..., :7] == exact[:7]).any()
    assert np.isnan(exact[7:]).all() and np.isfinite(got).all()


def _qt(shape, dtype=torch.int8):
    return QuantizedTensor(torch.zeros(shape, dtype=dtype),
                           torch.ones((*shape[:3], 1)))


@pytest.mark.parametrize("case", ["gqa", "window", "starts"])
def test_validation_raises_as_jax_asserts(case):
    """hq % hkv, a window without causal, segment_starts without ids: JAX
    asserts, the port raises ValueError."""
    q_shape, kv_shape = (1, 4, 64, 64), (1, 2, 64, 64)
    kw = {"window": {"causal": False, "window": 16},
          "starts": {"causal": True, "segment_starts": (0, 32)},
          "gqa": {"causal": True}}[case]
    if case == "gqa":
        q_shape = (1, 3, 64, 64)
    jk = JQ.QuantizedTensor(jnp.zeros(kv_shape, jnp.int8),
                            jnp.ones((*kv_shape[:3], 1), jnp.float32))
    with pytest.raises(AssertionError):
        jax_flash_quantized(jnp.zeros(q_shape, jnp.float32), jk, jk,
                            config=INTERP, **kw)
    with pytest.raises(ValueError):
        flash_attention_quantized(torch.zeros(q_shape), _qt(kv_shape),
                                  _qt(kv_shape), **kw)
