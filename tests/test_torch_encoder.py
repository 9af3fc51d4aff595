"""The port's encoder family against the JAX package's, on the CPU.

Mirrors tests/test_encoder.py on the port (the flash path against the
explicit masked-softmax oracle, pad invariance, batch-row independence) and
holds `encode` and `embed_texts` to JAX's at that file's config, from the
same weights (params_from_jax) and the same numpy tokens."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models import encoder as JE
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu_torch.models import encoder as E
from tiny_flash_attention_tpu_torch.models import transformer as TT

SMALL = dict(vocab_size=128, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=64, d_ff=256)
CFG = TT.ModelConfig(**SMALL, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = JT.ModelConfig(**SMALL, dtype=jnp.float32)
    jp = JT.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, TT.params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_encode_matches_jax(impl):
    """Hidden states on valid rows and the pooled vectors at the fp32
    gate; JAX's flash path is its segment-masked flash_attention."""
    jcfg, jp, tp = _models()
    toks = _tokens((2, 256), 1)
    lengths = np.array([200, 256], np.int32)
    jh, jpool = JE.encode(dataclasses.replace(jcfg, attn_impl=impl), jp,
                          jnp.asarray(toks), jnp.asarray(lengths))
    h, pool = E.encode(dataclasses.replace(CFG, attn_impl=impl), tp,
                       torch.from_numpy(toks), torch.from_numpy(lengths))
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(h[0, :200].numpy(), np.asarray(jh)[0, :200],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(h[1].numpy(), np.asarray(jh)[1], atol=2e-5,
                               rtol=0)
    want = JE.embed_texts(jcfg, jp, jnp.asarray(toks), jnp.asarray(lengths))
    got = E.embed_texts(CFG, tp, torch.from_numpy(toks),
                        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_encoder_flash_matches_oracle():
    _, _, tp = _models()
    tokens = torch.from_numpy(_tokens((2, 256), 2))
    lengths = torch.tensor([200, 256])
    h_f, p_f = E.encode(CFG, tp, tokens, lengths)
    ref = dataclasses.replace(CFG, attn_impl="reference")
    h_r, p_r = E.encode(ref, tp, tokens, lengths)
    torch.testing.assert_close(p_f, p_r, atol=2e-4, rtol=0)
    torch.testing.assert_close(h_f[0, :200], h_r[0, :200], atol=2e-4,
                               rtol=0)


def test_embedding_pad_invariant():
    _, _, tp = _models()
    body = torch.from_numpy(_tokens((1, 200), 3))
    pad_a = torch.cat([body, torch.full((1, 56), 7)], dim=1)
    pad_b = torch.cat([body, torch.full((1, 184), 13)], dim=1)
    lengths = torch.tensor([200])
    e_a = E.embed_texts(CFG, tp, pad_a, lengths)
    e_b = E.embed_texts(CFG, tp, pad_b, lengths)
    torch.testing.assert_close(e_a, e_b, atol=1e-5, rtol=0)
    torch.testing.assert_close(e_a.norm(dim=-1), torch.ones(1), atol=1e-5,
                               rtol=0)


def test_encoder_batch_row_independence():
    """The segment mask is per row: rows of a batch do not leak."""
    _, _, tp = _models()
    both = torch.from_numpy(_tokens((2, 128), 4))
    e_both = E.embed_texts(CFG, tp, both)
    e_solo = E.embed_texts(CFG, tp, both[:1])
    torch.testing.assert_close(e_both[0], e_solo[0], atol=1e-5, rtol=0)


def test_unknown_attn_impl_raises():
    _, _, tp = _models()
    with pytest.raises(ValueError, match="attn_impl"):
        E.encode(dataclasses.replace(CFG, attn_impl="splash"), tp,
                 torch.zeros((1, 8), dtype=torch.int32))
