"""The port's FA1 forward against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through JAX's FA1 Pallas kernel
in interpret mode (as tests/test_flash_fwd.py runs it) and through the port's
plain version, which keeps the kernel's rounding points (q scaled in its
dtype, log2-domain softmax, p cast to v's dtype before PV). Gates: fp32 2e-5,
bf16 2e-2; the LSE to 1e-5 relative. Rows that see no column (causal, q_len
> kv_len) are 0 in both; their LSE is the sentinel in the port, and in JAX
the sentinel or -inf by block, so the LSE is compared on the rows that see a
column.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops.flash_v1 import (
    flash_attention_v1 as jax_v1)
from tiny_flash_attention_tpu_torch.ops.flash import LN2
from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
    flash_attention_v1, flash_attention_v1_plain)
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(q_len, kv_len, dtype, seed, b=1, h=2, d=64):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, q_len, d), (b, h, kv_len, d), (b, h, kv_len, d))]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a, _JNP[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("q_len,kv_len,causal", [
    (300, 260, True),      # padded kv, q_len > kv_len inside one block
    (300, 260, False),
    (100, 260, True),      # the decode offset
    (300, 100, True),      # q_len > kv_len by more than a block
])
def test_v1_matches_jax_kernel(dtype, q_len, kv_len, causal):
    (q, k, v), (jq, jk, jv) = _inputs(q_len, kv_len, dtype, 0)
    out, lse = flash_attention_v1(q, k, v, causal=causal, block_q=128,
                                  block_kv=128, return_lse=True)
    jout, jlse = jax_v1(jq, jk, jv, causal=causal, block_q=128,
                        block_kv=128, return_lse=True, interpret=True)
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.shape == q.shape[:3]
    np.testing.assert_allclose(_np(out), _np(jout),
                               atol=tolerance_for(dtype), rtol=0)
    seen = max(0, q_len - kv_len) if causal else 0
    np.testing.assert_allclose(_np(lse)[:, :, seen:],
                               _np(jlse)[:, :, seen:], atol=0, rtol=1e-5)
    if seen:
        assert bool((out[:, :, :seen] == 0).all())
        sentinel = np.float32(np.float32(DEFAULT_MASK_VALUE) * LN2)
        np.testing.assert_array_equal(_np(lse)[:, :, :seen], sentinel)


def test_v1_plain_follows_block_free_semantics():
    """The plain version is the entry's CPU path, with the default scale;
    the TPU tile sizes change nothing."""
    (q, k, v), _ = _inputs(70, 90, torch.float32, 1)
    want = flash_attention_v1_plain(q, k, v, causal=True, sm_scale=0.125)
    for bq, bkv in ((512, 512), (16, 32)):
        got = flash_attention_v1(q, k, v, causal=True, block_q=bq,
                                 block_kv=bkv, return_lse=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(flash_attention_v1(q, k, v, causal=True), want[0])


def test_v1_rejects_gqa_and_bad_blocks():
    (q, k, v), _ = _inputs(8, 8, torch.float32, 2, h=4)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention_v1(q, k[:, :2], v[:, :2])
    with pytest.raises(ValueError, match="block"):
        flash_attention_v1(q, k, v, block_q=0)
