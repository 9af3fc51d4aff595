"""The decodes and the append at head dims and page sizes without an instance
of their own, against the JAX package, on the CPU.

The JAX package's decodes take any head_dim and any page size (int8 fused
pages: page_size <= head_dim or a multiple of it; separate int8 pages a
multiple of 128). The port's decode and append kernels read pages in place
at every head_dim up to 256: 64, 80, 96, 128 and 256 at page size 16 or a
multiple of 32 on instances of their own, every other head_dim and page
size on run-time width instances of width 64, 128 or 256 that score zeros
past the true width (ops/dims.py::decode_width). Here the rules are held
against JAX's, and the same numpy inputs, made from a seed, go through
JAX's kernels (interpret mode) or its engine's append, and through the
port: its public entry (the plain version on the CPU) and the width route,
what a run-time width instance computes (q and the pages' rows padded with
zero columns to the instance's width, the kernel's splits, the columns
below d kept). Gates: bf16 out at tolerance_for(bf16), the LSE at 1e-4
relative; the append bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models import inference as JI
from tiny_flash_attention_tpu.ops import paged_fused as jpf
from tiny_flash_attention_tpu.ops.paged import (
    paged_decode_attention as jax_paged)
from tiny_flash_attention_tpu_torch.ops import dims
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.0e}"


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a).to(dtype), jnp.asarray(a, _JNP[dtype])


# --- the rules ---------------------------------------------------------------


@pytest.mark.parametrize("d", range(1, 521))
def test_decode_rule_takes_every_head_dim_to_256(d):
    """decode_head_dim takes every head_dim in [1, 512] (q in bf16 and
    f32) and raises above 512, naming the kernel (and q's dtype) and queue
    B-dims-2a-512+; decode_width is d itself at the
    compiled widths (page size 16 or a multiple of 32), else the least run-
    time width that holds d; decode_group stops at 4 above 128 and at
    DECODE_TOP_512 above 256."""
    what = "the CUDA decode kernel"
    if d > 512:
        with pytest.raises(NotImplementedError, match="B-dims-2a-512+"):
            dims.decode_head_dim(d, what)
        with pytest.raises(NotImplementedError, match="decode kernel"):
            dims.decode_width(d, 48)
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(NotImplementedError, match="decode kernel "
                               f"with {str(dtype).split('.')[-1]} q.*"
                               "B-dims-2a-512+"):
                dims.decode_q_head_dim(d, dtype)
        return
    dims.decode_q_head_dim(d, torch.bfloat16)
    dims.decode_head_dim(d, "the CUDA append kernel")
    dims.decode_q_head_dim(d, torch.float32)
    width = next(w for w in (64, 128, 256, 512) if d <= w)
    for ps in (1, 8, 16, 24, 32, 48, 64, 100, 128, 160):
        compiled = d in (64, 80, 96, 128, 256, 512) and (
            ps == 16 or ps % 32 == 0)
        assert dims.decode_compiled(d, ps) == compiled
        assert dims.decode_width(d, ps) == (d if compiled else width)
    top = dims.DECODE_TOP_512 if d > 256 else 4 if d > 128 else 8
    assert dims.decode_group(8, d) == (top, 8 // top)
    assert dims.decode_group(64, d) == (top, 64 // top)


@pytest.mark.parametrize("d", [8, 36, 48, 64, 72, 100, 112, 128, 192, 256])
def test_page_rule_follows_jax(d):
    """kernel_page_size takes what JAX takes: any page size >= 1 for bf16
    pages, and for int8 fused pages exactly those JAX's
    scale_rows_per_side accepts (page_size <= head_dim or a multiple)."""
    for ps in range(1, 301):
        assert tpf.kernel_page_size(ps, d, "bf16")
        try:
            jpf.scale_rows_per_side(ps, d)
            jax_takes = True
        except AssertionError:
            jax_takes = False
        assert tpf.kernel_page_size(ps, d, "int8") == jax_takes, (ps, d)
        if jax_takes:
            assert tpf.scale_rows_per_side(ps, d) == \
                jpf.scale_rows_per_side(ps, d)
    assert not tpf.kernel_page_size(0, d, "bf16")


def test_pages_jax_refuses_raise():
    """int8 fused pages at (page size 48, head_dim 36) raise as JAX's
    assert does, in the decode and the append, before any launch."""
    pages = torch.zeros((1, 2, 2 * 48 + 16, 36), dtype=torch.int8)
    q = torch.zeros((1, 2, 36))
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(AssertionError):
        jpf.scale_rows_per_side(48, 36)
    with pytest.raises(ValueError, match="multiple"):
        tpf.fused_paged_decode_attention(q, pages, one + 3, one[:, None],
                                         page_size=48)
    with pytest.raises(ValueError, match="multiple"):
        tpf.fused_page_append(pages, q[:, :1], q[:, :1], one, one,
                              page_size=48)


# --- the decodes --------------------------------------------------------------


def _width_route(q, pages, lengths, table, d, ps, fmt, window, group_of):
    """What a run-time width instance computes: q rows padded to the
    instance's group, q and every page row padded with zero columns to its
    width (the scale rows of int8 pages repacked at that width), the plain
    version at the kernel's splits with the true head_dim's scale, the
    columns below d and the true q rows kept."""
    width = dims.decode_width(d, ps)
    hkv = pages.shape[0]
    rows, blocks = dims.decode_group(group_of, d)
    qp = dims.pad_head_dim(dims.pad_group(q, hkv, rows * blocks), width)
    if fmt == "int8":
        k, v, ks, vs = tpf.unpack_int8_pages(pages, ps)
        wk, wv = (dims.pad_head_dim(x, width) for x in (k, v))
        wpages = torch.cat([wk, wv, tpf._pack_scale_rows(ks, width),
                            tpf._pack_scale_rows(vs, width)], dim=-2)
    else:
        wpages = dims.pad_head_dim(pages, width)
    out, lse = tpf.fused_paged_decode_plain(
        qp, wpages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
        window=window, splits="kernel")
    out = dims.unpad_head_dim(out, d)
    return (dims.unpad_group(out, hkv, group_of),
            dims.unpad_group(lse, hkv, group_of))


# (head_dim, page size, format, group, window): the run-time widths' cases
DECODE_CASES = [(100, 48, "bf16", 1, None), (100, 48, "bf16", 3, 100),
                (100, 1, "bf16", 1, None), (100, 64, "int8", 1, None),
                (192, 48, "int8", 3, None), (36, 8, "bf16", 3, None),
                (112, 24, "bf16", 8, None)]


@pytest.mark.parametrize("d,ps,fmt,group,window", DECODE_CASES)
def test_fused_decode_matches_jax(d, ps, fmt, group, window):
    """JAX's fused decode (interpret mode) over pages packed by JAX at a
    page size and head_dim no compiled instance takes, lengths 1, a page
    edge, a ragged one and the full table (ring mode: past the ring's
    capacity); the port's entry and its width route."""
    rng = np.random.default_rng(d + ps + group)
    B, hkv = 4, 2
    P = max(3, -(-150 // ps)) if window else 3 if ps > 8 else 12
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)), torch.bfloat16)
    kp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    if fmt == "int8":
        jpages = jpf.pack_paged_cache(jnp.asarray(kp), jnp.asarray(vp),
                                      "int8")
        pages = torch.from_numpy(np.array(jpages))
    else:
        kt, jk = _both(kp, torch.bfloat16)
        vt, jv = _both(vp, torch.bfloat16)
        pages = tpf.pack_paged_cache(kt, vt, "bf16")
        jpages = jpf.pack_paged_cache(jk, jv, "bf16")
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, ps, ps + P * ps // 2 - 1, P * ps], np.int32)
    if window is not None:
        lengths = np.array([1, 150, P * ps + 9, 3 * P * ps + 30], np.int32)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps,
        window=window)
    args = (q, pages, torch.from_numpy(lengths), torch.from_numpy(table))
    atol = tolerance_for(torch.bfloat16)
    out, lse = tpf.fused_paged_decode_attention(*args, page_size=ps,
                                                window=window)
    wout, wlse = _width_route(*args, d, ps, fmt, window, group)
    for name, (o, l) in (("entry", (out, lse)), ("width", (wout, wlse))):
        _close(o, jout, atol, f"{name} out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=atol, rtol=1e-4)


def test_separate_decode_matches_jax():
    """B12 at head_dim 100, page size 48, bf16, group 2: JAX's
    paged_decode_attention (interpret mode) against the port's entry and
    its width route (zero columns to 128, the kernel's splits)."""
    rng = np.random.default_rng(100)
    B, hkv, group, d, ps, P = 3, 2, 2, 100, 48, 4
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)), torch.bfloat16)
    k, jk = _both(rng.standard_normal((hkv, NP, ps, d)), torch.bfloat16)
    v, jv = _both(rng.standard_normal((hkv, NP, ps, d)), torch.bfloat16)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, 97, P * ps], np.int32)
    jout, jlse = jax_paged(jq, jk, jv, jnp.asarray(lengths),
                           jnp.asarray(table), interpret=True)
    tl, tt = torch.from_numpy(lengths), torch.from_numpy(table)
    out, lse = paged_decode_attention(q, k, v, tl, tt)
    width = dims.decode_width(d, ps)
    rows, blocks = dims.decode_group(group, d)
    wout, wlse = paged_decode_plain(
        dims.pad_head_dim(dims.pad_group(q, hkv, rows * blocks), width),
        *(dims.pad_head_dim(x, width) for x in (k, v)), tl, tt,
        sm_scale=d ** -0.5, splits="kernel")
    wout = dims.unpad_group(dims.unpad_head_dim(wout, d), hkv, group)
    wlse = dims.unpad_group(wlse, hkv, group)
    atol = tolerance_for(torch.bfloat16)
    for o, l in ((out, lse), (wout, wlse)):
        _close(o, jout, atol, "out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=atol, rtol=1e-4)


# --- the append ---------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("d,ps", [(100, 48), (36, 8), (100, 100)])
def test_append_matches_jax(d, ps, fmt):
    """The append at head dims and page sizes no compiled instance takes,
    against the JAX engine's append (`_append_rows_scatter`) bit for bit:
    the rows, and for int8 pages their amax, rounding and scale bytes (at
    page size 8 and head_dim 36, 8 tokens in one group of scale rows)."""
    rng = np.random.default_rng(d + ps)
    B, hkv, npages = 3, 2, 8
    prows = tpf.page_rows(ps, d, fmt)
    raw = rng.integers(-5, 5, (hkv, npages, prows, d))
    if fmt == "int8":
        pages = torch.from_numpy(raw.astype(np.int8))
        jpages = jnp.asarray(raw, jnp.int8)
    else:
        pages, jpages = _both(raw, torch.bfloat16)
    k_new, jk = _both(rng.standard_normal((B, hkv, d)) * 3, torch.bfloat16)
    v_new, jv = _both(rng.standard_normal((B, hkv, d)), torch.bfloat16)
    ids = np.array([0, 3, 7], np.int32)
    rows = np.array([0, ps // 2, ps - 1], np.int32)
    got = tpf.fused_page_append(pages, k_new, v_new, torch.from_numpy(ids),
                                torch.from_numpy(rows), page_size=ps)
    want = np.asarray(JI._append_rows_scatter(
        jpages, jk, jv, jnp.asarray(ids), jnp.asarray(rows), page_size=ps,
        fmt=fmt))
    if fmt == "bf16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)
