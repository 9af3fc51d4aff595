"""The port's flash_attention against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX entry (its XLA
route at q_len, kv_len <= 512, its Pallas work-list and triangle kernels in
interpret mode above that) and through the port's plain version. Gates are
the dtype tiers of utils/testing.py: fp32 2e-5, bf16 2e-2, fp16 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from tiny_flash_attention_tpu.ops.flash_tri import tri_eligible
from tiny_flash_attention_tpu_torch.ops.flash import (
    LN2, flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE, mha_reference)
from tiny_flash_attention_tpu_torch.utils.testing import (
    flash_gate, fold_q, tolerance_for)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


def _inputs(q_shape, kv_shape, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a, _JNP[dtype]) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, atol, name):
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.0e}"


CASES = [
    # (q_shape, kv_shape, causal)
    pytest.param((2, 4, 128, 64), (2, 2, 128, 64), True, id="causal-gqa"),
    pytest.param((2, 4, 96, 64), (2, 2, 96, 64), False, id="noncausal-gqa"),
    pytest.param((1, 4, 16, 64), (1, 4, 200, 64), True, id="decode-offset"),
    pytest.param((1, 4, 200, 64), (1, 2, 70, 64), True, id="q-longer-than-kv"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("q_shape,kv_shape,causal", CASES)
def test_flash_matches_jax(q_shape, kv_shape, causal, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(q_shape, kv_shape, dtype, seed=1)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    jout, jlse = jax_flash(jq, jk, jv, causal=causal, return_lse=True)
    assert out.dtype == dtype and out.shape == q.shape
    _check(out, jout, tolerance_for(dtype), "out")
    # the LSE is f32 in both; the inputs' rounding bounds its difference
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               rtol=1e-5, atol=tolerance_for(dtype))


def test_fully_masked_rows_zero_with_lse_sentinel():
    """Causal q_len > kv_len: the first q_len - kv_len rows see nothing;
    they output 0 and carry the kernel's log2-domain sentinel m * ln2."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 2, 40, 64), (1, 2, 8, 64),
                                      torch.float32, seed=2)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    jout, jlse = jax_flash(jq, jk, jv, causal=True, return_lse=True)
    assert torch.all(out[:, :, :32] == 0)
    np.testing.assert_allclose(lse[:, :, :32].numpy(),
                               DEFAULT_MASK_VALUE * LN2, rtol=1e-6)
    np.testing.assert_array_equal(lse[:, :, :32].numpy(),
                                  np.asarray(jlse)[:, :, :32])
    _check(out, jout, 2e-5, "out")


def test_window_matches_jax():
    (q, k, v), (jq, jk, jv) = _inputs((1, 4, 160, 64), (1, 2, 160, 64),
                                      torch.float32, seed=3)
    out, lse = flash_attention(q, k, v, causal=True, window=32,
                               return_lse=True)
    jout, jlse = jax_flash(jq, jk, jv, causal=True, window=32,
                           return_lse=True)
    _check(out, jout, 2e-5, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5)


def test_segments_match_jax():
    """Packed segments, with a padding id that no query row shares: its
    rows are empty in the kv columns of the other segments only."""
    (q, k, v), (jq, jk, jv) = _inputs((2, 2, 96, 64), (2, 2, 96, 64),
                                      torch.float32, seed=4)
    seg = np.repeat(np.array([[1, 2, 3], [1, 1, 2]], np.int32), 32, axis=1)
    kv_seg = seg.copy()
    kv_seg[0, :40] = 9          # row 0's segment 1 finds no kv column
    tseg = (torch.from_numpy(seg), torch.from_numpy(kv_seg))
    jseg = (jnp.asarray(seg), jnp.asarray(kv_seg))
    for causal in (False, True):
        out, lse = flash_attention(q, k, v, causal=causal, segment_ids=tseg,
                                   return_lse=True)
        jout, jlse = jax_flash(jq, jk, jv, causal=causal, segment_ids=jseg,
                               return_lse=True)
        _check(out, jout, 2e-5, f"out causal={causal}")
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5)
    assert torch.all(out[0, :, :32] == 0)


@pytest.mark.parametrize("q_shape,kv_shape", [
    # 512 < L < 1024: the JAX entry takes the work-list kernel (_fwd_kernel)
    pytest.param((1, 4, 640, 64), (1, 2, 640, 64), id="worklist-kernel"),
    # L >= 1024, q_len == kv_len: the triangle kernel (_tri_kernel)
    pytest.param((1, 4, 1024, 64), (1, 2, 1024, 64), id="tri-kernel"),
])
def test_flash_matches_jax_pallas_kernels(q_shape, kv_shape):
    """The port's plain version against the Pallas kernels in interpret
    mode. The kernels fold sm_scale * log2(e) into q in bf16 before the
    dot; the plain version scales the f32 scores after it, as
    _xla_attention does. The bf16 gate covers that rounding."""
    if q_shape[2] >= 1024:
        assert tri_eligible(q_shape, kv_shape[1], kv_shape[2], True, None,
                            None, None, jnp.bfloat16)
    (q, k, v), (jq, jk, jv) = _inputs(q_shape, kv_shape, torch.bfloat16,
                                      seed=5)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    jout, jlse = jax_flash(jq, jk, jv, causal=True, return_lse=True)
    _check(out, jout, 2e-2, "out")
    _check(lse, jlse, 2e-2, "lse")


def test_plain_matches_reference_oracle():
    """mha_reference (the oracle) and the plain forward agree in f32."""
    (q, k, v), _ = _inputs((2, 4, 48, 64), (2, 2, 80, 64), torch.float32, 6)
    for causal in (False, True):
        got = flash_attention_plain(q, k, v, causal=causal, sm_scale=0.125)
        want = mha_reference(q, k, v, causal=causal, sm_scale=0.125)
        _check(got, want, 2e-5, f"causal={causal}")


def test_validation_matches_jax():
    (q, k, v), _ = _inputs((1, 3, 16, 64), (1, 2, 16, 64), torch.float32, 7)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, k, v)
    (q, k, v), _ = _inputs((1, 2, 16, 64), (1, 2, 16, 64), torch.float32, 7)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention(q, k, v, segment_starts=(0,))


@pytest.mark.parametrize("q_shape,kv_shape", [
    pytest.param((1, 4, 640, 64), (1, 2, 640, 64), id="worklist-kernel"),
    pytest.param((1, 4, 1024, 128), (1, 2, 1024, 128), id="tri-kernel"),
])
def test_bf16_gate_at_the_fold_holds_the_kernels_and_catches_faults(
        q_shape, kv_shape):
    """The bf16 forward's gate (utils/testing.py::flash_gate) on JAX's
    Pallas kernels in interpret mode, whose q fold the CUDA kernel
    repeats: they pass it against the port's plain version. A stale V
    tile (tile 3's V read for tile 4) or a dropped kv tile (tile 4) in the
    rows of the last 128-row q tile of the plain version on the folded q
    fails it."""
    (q, k, v), (jq, jk, jv) = _inputs(q_shape, kv_shape, torch.bfloat16,
                                      seed=5)

    def plain(x, sc, vv=v, ids=None):
        return flash_attention_plain(x, k, vv, causal=True, sm_scale=sc,
                                     segment_ids=ids, return_lse=True)

    jout, jlse = jax_flash(jq, jk, jv, causal=True, return_lse=True)
    out = torch.from_numpy(_f32(jout)).to(torch.bfloat16)
    lse = torch.from_numpy(np.asarray(jlse))
    assert flash_gate(out, lse, plain, q, torch.bfloat16)[2]

    qf, scale = fold_q(q, q_shape[-1] ** -0.5)
    rows, tile = slice(q_shape[2] - 128, None), slice(512, 640)
    stale = v.clone()
    stale[:, :, tile] = v[:, :, 384:512]
    kv_ids = torch.zeros((1, kv_shape[2]), dtype=torch.int32)
    kv_ids[:, tile] = 1
    q_ids = torch.zeros((1, 128), dtype=torch.int32)
    for fault in (plain(qf[:, :, rows], scale, vv=stale),
                  plain(qf[:, :, rows], scale, ids=(q_ids, kv_ids))):
        bad_out, bad_lse = plain(qf, scale)
        bad_out[:, :, rows], bad_lse[:, :, rows] = fault
        assert not flash_gate(bad_out, bad_lse, plain, q, torch.bfloat16)[2]
