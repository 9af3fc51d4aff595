"""The port's fused-page decode against the JAX package's, on the CPU.

The JAX side runs `_fused_decode_kernel` in interpret mode; the port runs
its plain version, which repeats the kernel's arithmetic (q scaled by
sm_scale * log2(e) in the input dtype, log2-domain softmax, p rounded to the
input dtype before the PV product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops import paged_fused as jpf
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(a, dtype):
    return torch.from_numpy(a).to(dtype), jnp.asarray(a, _JNP[dtype])


def _bits(x):
    """A bf16 or f32 array's bits as an integer numpy array."""
    if isinstance(x, torch.Tensor):
        view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return x.contiguous().view(view).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def test_pack_paged_cache_byte_identical():
    rng = np.random.default_rng(0)
    kp = rng.standard_normal((2, 5, 16, 64)).astype(np.float32)
    vp = rng.standard_normal((2, 5, 16, 64)).astype(np.float32)
    tk, jk = _both(kp, torch.bfloat16)
    tv, jv = _both(vp, torch.bfloat16)
    got = tpf.pack_paged_cache(tk, tv, fmt="bf16")
    want = jpf.pack_paged_cache(jk, jv, fmt="bf16")
    assert tuple(got.shape) == want.shape == (2, 5, 32, 64)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for ps, d in [(16, 64), (64, 64), (256, 128)]:
        assert tpf.scale_rows_per_side(ps, d) == jpf.scale_rows_per_side(ps, d)
    with pytest.raises(ValueError):
        tpf.pack_paged_cache(tk, tv, fmt="fp8")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("group", [1, 4])
def test_decode_matches_jax_kernel(dtype, group):
    """Lengths 1, a page edge, a full table and a ragged one, over a
    random page permutation."""
    rng = np.random.default_rng(1)
    B, hkv, d, ps, P, NP = 4, 2, 64, 16, 4, 20
    hq = hkv * group
    q, jq = _both(rng.standard_normal((B, hq, d)).astype(np.float32), dtype)
    pages, jpages = _both(
        rng.standard_normal((hkv, NP, 2 * ps, d)).astype(np.float32), dtype)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, ps, P * ps, 37], np.int32)
    out, lse = tpf.fused_paged_decode_attention(
        q, pages, torch.from_numpy(lengths), torch.from_numpy(table),
        page_size=ps)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps)
    assert out.dtype == dtype and out.shape == (B, hq, d)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=tolerance_for(dtype), rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               atol=tolerance_for(dtype), rtol=1e-5)


def test_decode_column_slice_and_clamp():
    """A column slice of a wider page table (the engine's bucketed width)
    gives the same result as the full table when the lengths fit, and a
    length past the table width attends the whole table, never past it."""
    rng = np.random.default_rng(2)
    B, hkv, hq, d, ps, P, NP = 3, 2, 4, 64, 16, 8, 30
    q = torch.from_numpy(rng.standard_normal((B, hq, d)).astype(np.float32))
    pages = torch.from_numpy(
        rng.standard_normal((hkv, NP, 2 * ps, d)).astype(np.float32))
    table = torch.from_numpy(
        rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32))
    lengths = torch.tensor([5, 32, 64], dtype=torch.int32)
    sliced = table[:, :4]
    assert not sliced.is_contiguous()
    full = tpf.fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps)
    part = tpf.fused_paged_decode_attention(q, pages, lengths, sliced,
                                            page_size=ps)
    for a, b in zip(full, part):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    over = tpf.fused_paged_decode_attention(
        q, pages, torch.tensor([500, 500, 500], dtype=torch.int32), sliced,
        page_size=ps)
    cap = tpf.fused_paged_decode_attention(
        q, pages, torch.tensor([64, 64, 64], dtype=torch.int32), sliced,
        page_size=ps)
    for a, b in zip(over, cap):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("group", [1, 4])
def test_ring_decode_matches_jax_kernel(dtype, group):
    """The ring mode (window) against JAX's in interpret mode: lengths 1, a
    window band across a page edge, a ring wrapped once and one wrapped
    three times, over a random page permutation."""
    rng = np.random.default_rng(3)
    B, hkv, d, ps, P, NP = 4, 2, 64, 16, 4, 20
    hq = hkv * group
    q, jq = _both(rng.standard_normal((B, hq, d)).astype(np.float32), dtype)
    pages, jpages = _both(
        rng.standard_normal((hkv, NP, 2 * ps, d)).astype(np.float32), dtype)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, 41, P * ps + 9, 3 * P * ps + 30], np.int32)
    out, lse = tpf.fused_paged_decode_attention(
        q, pages, torch.from_numpy(lengths), torch.from_numpy(table),
        page_size=ps, window=35)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps,
        window=35)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=tolerance_for(dtype), rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               atol=tolerance_for(dtype), rtol=1e-5)


def test_decode_rejects_what_is_not_ported():
    """Bad page geometry and a window past the ring's capacity raise; a
    window inside it is the ring mode, over int8 and bf16 pages alike, and
    agrees with JAX's."""
    q = torch.zeros((1, 2, 64))
    pages = torch.zeros((1, 4, 2 * 16 + 8, 64), dtype=torch.int8)
    lengths = torch.ones(1, dtype=torch.int32)
    table = torch.zeros((1, 2), dtype=torch.int32)
    for p in (pages, torch.zeros((1, 4, 32, 64))):
        out, lse = tpf.fused_paged_decode_attention(
            q, p, lengths, table, page_size=16, window=8)
        jout, jlse = jpf.fused_paged_decode_attention(
            jnp.asarray(q.numpy()), jnp.asarray(p.numpy()),
            jnp.asarray(lengths.numpy()), jnp.asarray(table.numpy()),
            page_size=16, window=8)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6)
        with pytest.raises(ValueError, match="window"):
            tpf.fused_paged_decode_attention(q, p, lengths, table,
                                             page_size=16, window=33)
    with pytest.raises(ValueError, match="int8 pages"):
        tpf.fused_paged_decode_attention(
            q, pages[:, :, :36], torch.ones(1, dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), page_size=16)
    with pytest.raises(ValueError, match="page_size"):
        tpf.fused_paged_decode_attention(
            q, torch.zeros((1, 4, 24, 64)), torch.ones(1, dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), page_size=16)
