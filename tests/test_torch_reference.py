"""The port's oracle ladder against the JAX package's, on the CPU.

Each rung of tiny_flash_attention_tpu/ops/reference.py and its port take the
same numpy inputs (made from a seed) through `mha_reference(impl=...)`; the
port's rungs also hold against its own naive rung, as tests/test_reference.py
holds JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops import reference as JR
from tiny_flash_attention_tpu_torch.ops import reference as TR
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
RUNGS = ["attention_naive", "attention_safe", "attention_online",
         "flash_attention_v1_ref", "flash_attention_v2_ref"]


def _qkv(seed, bs, hq, hkv, q_len, kv_len, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((bs, hq, q_len, d), (bs, hkv, kv_len, d),
                      (bs, hkv, kv_len, d))]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a, _JNP[dtype]) for a in arrs])


def _both(rung, seed, shape, dtype=torch.float32, **kw):
    """(port result, JAX result) of mha_reference with one rung."""
    (tq, tk, tv), (jq, jk, jv) = _qkv(seed, *shape, dtype=dtype)
    got = TR.mha_reference(tq, tk, tv, impl=getattr(TR, rung), **kw)
    want = JR.mha_reference(jq, jk, jv, impl=getattr(JR, rung), **kw)
    return got, want


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("causal", [False, True])
def test_rung_matches_jax(rung, causal):
    got, want = _both(rung, 0, (2, 2, 2, 128, 128, 64), causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("rung", ["attention_naive", "flash_attention_v1_ref",
                                  "flash_attention_v2_ref"])
@pytest.mark.parametrize("q_len,kv_len", [(1, 128), (7, 128), (128, 64),
                                          (100, 200)])
def test_decode_shapes_match_jax(rung, q_len, kv_len):
    """q_len != kv_len: the decode offset, and rows that see nothing (the
    online rung is the FA2 one with one q block)."""
    kw = dict(block_q=32, block_kv=32) if rung.startswith("flash") else {}
    got, want = _both(rung, 1, (1, 4, 4, q_len, kv_len, 64), causal=True,
                      **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("rung", RUNGS)
def test_gqa_nondivisible_and_scale_match_jax(rung):
    """8 q heads over 2 kv heads, lengths off the blocks, a given scale."""
    kw = dict(block_kv=32) if rung != "attention_naive" and \
        rung != "attention_safe" else {}
    got, want = _both(rung, 2, (2, 8, 2, 100, 100, 32), causal=True,
                      sm_scale=0.3, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("rung", RUNGS)
def test_bf16_rung_matches_jax(rung):
    got, want = _both(rung, 3, (1, 2, 2, 128, 128, 64), torch.bfloat16,
                      causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=tolerance_for(torch.bfloat16), rtol=0)


@pytest.mark.parametrize("q_len,kv_len,causal", [(128, 128, True),
                                                 (100, 200, True),
                                                 (130, 64, True),
                                                 (64, 97, False)])
def test_lse_matches_jax(q_len, kv_len, causal):
    (tq, tk, tv), (jq, jk, jv) = _qkv(4, 1, 4, 2, q_len, kv_len, 64)
    out, lse = TR.mha_reference(tq, tk, tv, causal=causal,
                                impl=TR.flash_attention_v2_ref,
                                return_lse=True, block_q=32, block_kv=32)
    jout, jlse = JR.mha_reference(jq, jk, jv, causal=causal,
                                  impl=JR.flash_attention_v2_ref,
                                  return_lse=True, block_q=32, block_kv=32)
    assert lse.shape == (1, 4, q_len)
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=0, rtol=1e-5)


@pytest.mark.parametrize("rung", RUNGS[1:])
@pytest.mark.parametrize("causal", [False, True])
def test_ladder_vs_naive(rung, causal):
    """The port's ladder against its own naive rung (tests/test_reference.py
    holds JAX's so)."""
    (q, k, v), _ = _qkv(5, 2, 2, 2, 128, 128, 64)
    want = TR.mha_reference(q, k, v, causal=causal)
    got = TR.mha_reference(q, k, v, causal=causal, impl=getattr(TR, rung))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_lse_is_the_masked_logsumexp():
    (q, k, v), _ = _qkv(6, 1, 2, 2, 128, 128, 64)
    _, lse = TR.mha_reference(q, k, v, causal=True,
                              impl=TR.flash_attention_v2_ref,
                              return_lse=True)
    s = torch.matmul(q, k.transpose(-1, -2)) / 8.0
    s = torch.where(TR.causal_mask(128, 128), s, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-4,
                               rtol=0)


def test_default_rung_keeps_the_old_contract():
    """mha_reference(q, k, v, causal=, sm_scale=) is the naive rung in q's
    dtype, GQA included, and a bad head count raises."""
    (q, k, v), _ = _qkv(7, 1, 4, 2, 33, 50, 32, torch.bfloat16)
    got = TR.mha_reference(q, k, v, causal=True, sm_scale=0.2)
    want = TR.attention_naive(q, k.repeat_interleave(2, 1),
                              v.repeat_interleave(2, 1), causal=True,
                              sm_scale=0.2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="multiple"):
        TR.mha_reference(q[:, :3], k, v)
