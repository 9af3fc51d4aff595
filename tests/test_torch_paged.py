"""The port's separate-array paged decode against the JAX package's, on the
CPU.

The same numpy inputs, made from a seed, go through JAX's
`paged_decode_attention` (its Pallas kernel in interpret mode) and through
the port's plain version; the cases are those of tests/test_paged.py: f32
pages at page_size 64 over a random page permutation, bf16 pages with the
LSE, and int8 QuantizedTensor pages at page_size 128 made by the port's
quantizer, held to 1e-4 as JAX holds its own kernel. Only lengths in [1,
P * page_size] are compared: JAX leaves the output unwritten outside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops import quant as JQ
from tiny_flash_attention_tpu.ops.paged import (
    paged_decode_attention as jax_paged)
from tiny_flash_attention_tpu_torch.ops import quant as TQ
from tiny_flash_attention_tpu_torch.ops.flash import LN2
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _cache(seed, batch, hq, hkv, d, ps, P, extra=3):
    """q (batch, hq, d), K and V pages (hkv, batch * P + extra, ps, d) and a
    random page table, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    num_pages = batch * P + extra
    q = rng.standard_normal((batch, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    table = rng.permutation(num_pages)[:batch * P].reshape(batch, P)
    return q, kp, vp, table.astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("lengths", [[256, 256], [64, 200], [1, 511]])
def test_f32_pages_match_jax(lengths):
    q, kp, vp, table = _cache(0, len(lengths), 8, 2, 64, 64, 8)
    lens = np.asarray(lengths, np.int32)
    out, lse = paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, lens, table)),
        pages_per_block=2)
    jout, jlse = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, lens,
                                                       table)),
                           pages_per_block=2, interpret=True)
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=0, rtol=1e-5)


def test_bf16_pages_and_lse_match_jax():
    q, kp, vp, table = _cache(1, 2, 4, 4, 128, 64, 4)
    lens = np.asarray([128, 256], np.int32)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    out, lse = paged_decode_attention(*t, torch.from_numpy(lens),
                                      torch.from_numpy(table))
    jout, jlse = jax_paged(*j, jnp.asarray(lens), jnp.asarray(table),
                           pages_per_block=2, interpret=True)
    assert out.dtype == torch.bfloat16 and lse.shape == (2, 4)
    np.testing.assert_allclose(_np(out), _np(jout),
                               atol=tolerance_for(torch.bfloat16), rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse),
                               atol=tolerance_for(torch.bfloat16), rtol=1e-5)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_pages_match_jax(qdtype):
    """int8 QuantizedTensor pages (page_size 128) made by the port's
    quantize_int8, handed to JAX as its QuantizedTensor."""
    q, kp, vp, table = _cache(2, 2, 8, 2, 64, 128, 4)
    lens = np.asarray([300, 512], np.int32)
    kq = TQ.quantize_int8(torch.from_numpy(kp), axis=-1)
    vq = TQ.quantize_int8(torch.from_numpy(vp), axis=-1)
    assert kq.scales.shape == (2, 11, 128, 1)
    jk = JQ.QuantizedTensor(jnp.asarray(kq.values.numpy()),
                            jnp.asarray(kq.scales.numpy()))
    jv = JQ.QuantizedTensor(jnp.asarray(vq.values.numpy()),
                            jnp.asarray(vq.scales.numpy()))
    tq = torch.from_numpy(q).to(qdtype)
    out, lse = paged_decode_attention(tq, kq, vq, torch.from_numpy(lens),
                                      torch.from_numpy(table),
                                      pages_per_block=2)
    jout, jlse = jax_paged(jnp.asarray(q, _JNP[qdtype]), jk, jv,
                           jnp.asarray(lens), jnp.asarray(table),
                           pages_per_block=2, interpret=True)
    atol = 1e-4 if qdtype == torch.float32 else tolerance_for(qdtype)
    np.testing.assert_allclose(_np(out), _np(jout), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=atol, rtol=1e-5)


def test_length_zero_and_past_the_table():
    """Where JAX leaves the output unwritten the port gives out 0 with the
    LSE sentinel (length 0) and attends the whole table (a length past
    it)."""
    q, kp, vp, table = _cache(3, 3, 4, 2, 64, 16, 4)
    t = [torch.from_numpy(a) for a in (q, kp, vp)]
    tab = torch.from_numpy(table)
    out, lse = paged_decode_attention(
        *t, torch.tensor([0, 1000, 64], dtype=torch.int32), tab)
    assert bool((out[0] == 0).all())
    torch.testing.assert_close(
        lse[0], torch.full((4,), DEFAULT_MASK_VALUE * LN2), rtol=1e-6,
        atol=0)
    full = paged_decode_plain(*t, torch.tensor([64, 64, 64]), tab,
                              sm_scale=0.125)
    torch.testing.assert_close(out[1:], full[0][1:], rtol=0, atol=0)
    torch.testing.assert_close(lse[1:], full[1][1:], rtol=0, atol=0)


def test_rejects_what_jax_asserts():
    q, kp, vp, table = _cache(4, 1, 4, 2, 64, 64, 4)
    t = [torch.from_numpy(a) for a in (q, kp, vp)]
    lens, tab = torch.tensor([5], dtype=torch.int32), torch.from_numpy(table)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged_decode_attention(t[0][:, :3], t[1], t[2], lens, tab)
    with pytest.raises(ValueError, match="pages_per_block"):
        paged_decode_attention(*t, lens, tab, pages_per_block=3)
    kq = TQ.quantize_int8(t[1], axis=-1)       # page_size 64: not % 128
    vq = TQ.quantize_int8(t[2], axis=-1)
    with pytest.raises(ValueError, match="page_size % 128"):
        paged_decode_attention(t[0], kq, vq, lens, tab)
    with pytest.raises(ValueError, match="both"):
        paged_decode_attention(t[0], kq, t[2], lens, tab)
