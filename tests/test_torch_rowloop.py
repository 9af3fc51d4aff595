"""The port's flash_attention_rowloop against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through JAX's row-loop Pallas
kernel in interpret mode and through the port's plain version. Gates are
the dtype tiers: fp32 2e-5, bf16 2e-2. In the jagged mode rows below a
row's length are compared with JAX; rows at or past it, garbage in JAX,
are empty rows in the port (out 0, the LSE sentinel m * ln2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops.flash_rowloop import (
    flash_attention_rowloop as jax_rowloop)
from tiny_flash_attention_tpu_torch.ops.flash import LN2
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop, flash_attention_rowloop_plain)
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(q_shape, kv_shape, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a, _JNP[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = [
    # (q_shape, kv_shape, causal, seq_lengths)
    pytest.param((2, 4, 160, 64), (2, 2, 160, 64), True, None, id="causal"),
    pytest.param((1, 4, 96, 64), (1, 2, 96, 64), False, None,
                 id="noncausal"),
    pytest.param((1, 4, 24, 64), (1, 2, 200, 64), True, None,
                 id="decode-offset"),
    pytest.param((3, 4, 192, 64), (3, 2, 192, 64), True, [192, 65, 1],
                 id="jagged"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("q_shape,kv_shape,causal,lengths", CASES)
def test_rowloop_matches_jax(q_shape, kv_shape, causal, lengths, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(q_shape, kv_shape, dtype, seed=11)
    out, lse = flash_attention_rowloop(q, k, v, causal=causal,
                                       seq_lengths=lengths)
    jout, jlse = jax_rowloop(
        jq, jk, jv, causal=causal,
        seq_lengths=None if lengths is None else jnp.asarray(lengths,
                                                             jnp.int32))
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    atol = tolerance_for(dtype)
    lens = lengths or [q_shape[2]] * q_shape[0]
    for b, L in enumerate(lens):
        err = np.max(np.abs(_np(out[b, :, :L]) - _np(jout[b, :, :L])))
        assert err <= atol, f"out row {b}: {err:.3e} > {atol:.0e}"
        np.testing.assert_allclose(lse[b, :, :L].numpy(),
                                   np.asarray(jlse)[b, :, :L], rtol=1e-5,
                                   atol=atol)
        # past the length: empty rows, never JAX's garbage
        assert torch.all(out[b, :, L:] == 0)
        np.testing.assert_allclose(lse[b, :, L:].numpy(),
                                   DEFAULT_MASK_VALUE * LN2, rtol=1e-6)


def test_jagged_rows_equal_their_own_unpadded_problem():
    """Row b with length L attends exactly like the unpadded (L, L)
    causal problem alone."""
    (q, k, v), _ = _inputs((2, 4, 128, 64), (2, 2, 128, 64), torch.float32,
                           seed=12)
    out, lse = flash_attention_rowloop(q, k, v, causal=True,
                                       seq_lengths=torch.tensor([128, 37]))
    alone, alone_lse = flash_attention_rowloop(
        q[1:, :, :37], k[1:, :, :37], v[1:, :, :37], causal=True)
    torch.testing.assert_close(out[1, :, :37], alone[0], rtol=0, atol=2e-6)
    torch.testing.assert_close(lse[1, :, :37], alone_lse[0], rtol=0,
                               atol=2e-6)


def test_validation_matches_jax_asserts():
    (q, k, v), _ = _inputs((2, 2, 32, 64), (2, 2, 32, 64), torch.float32, 13)
    lens = torch.tensor([32, 5])
    with pytest.raises(ValueError, match="jagged"):
        flash_attention_rowloop(q, k, v, causal=False, seq_lengths=lens)
    with pytest.raises(ValueError, match="jagged"):
        flash_attention_rowloop(q, k[:, :, :16], v[:, :, :16], causal=True,
                                seq_lengths=lens)
    with pytest.raises(ValueError, match="jagged"):
        flash_attention_rowloop(q, k, v, causal=True, window=8,
                                seq_lengths=lens)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_rowloop(q, k, v, window=8)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention_rowloop(q[:, :1].repeat(1, 3, 1, 1), k, v)


def test_window_matches_jax():
    (q, k, v), (jq, jk, jv) = _inputs((1, 4, 160, 64), (1, 2, 160, 64),
                                      torch.float32, seed=14)
    out, lse = flash_attention_rowloop_plain(q, k, v, causal=True,
                                             sm_scale=0.125, window=40)
    jout, jlse = jax_rowloop(jq, jk, jv, causal=True, window=40)
    assert np.max(np.abs(_np(out) - _np(jout))) <= 2e-5
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5)
