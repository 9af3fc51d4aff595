"""The port's masked flash-attention backward against the JAX package's.

The same numpy inputs, made from a seed, go through JAX's
`flash_attention_bwd` in interpret mode (on its fused and its split path)
and through the port's `flash_attention_bwd` (its plain version on the
CPU), with the sliding window, segment ids and static `segment_starts`;
then `flash_attention`'s autograd Function with these masks against torch
autograd through the plain forward; then the backward's tile tables
against JAX's work lists, and the order of the bf16 kernels' dQ sums
built from them. Gates: f32 1e-5, bf16 2e-2 of the largest |gradient|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_flash_attention_tpu.ops.flash_bwd as JFB
from tiny_flash_attention_tpu.ops.flash import _xla_attention
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_BWD_BF16, FLASH_BWD_F32)
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    bwd_tiles, dq_chain, flash_attention_bwd)
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ids(b, n, bounds):
    ids = np.zeros((b, n), np.int32)
    for x in bounds:
        ids[:, x:] += 1
    return ids + 10 * np.arange(b, dtype=np.int32)[:, None]


def _inputs(q_shape, kv_shape, dtype, seed, *, causal, window, segs):
    """(torch q, k, v, out, lse, do), (the same in JAX); out and lse from
    JAX's `_xla_attention` with the masks."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape, q_shape)]
    jq, jk, jv, jdo = (jnp.asarray(a, _JNP[dtype]) for a in arrs)
    jsegs = None if segs is None else tuple(jnp.asarray(s) for s in segs)
    jout, jlse = _xla_attention(jq, jk, jv, jsegs, causal,
                                q_shape[-1] ** -0.5, True, window)
    jax_args = (jq, jk, jv, jout, jlse, jdo)
    torch_args = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
                  for a in jax_args]
    torch_args = [t if i == 4 else t.to(dtype)      # the LSE stays f32
                  for i, t in enumerate(torch_args)]
    return tuple(torch_args), jax_args, jsegs


def _check(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape, name
        atol = 1e-5 if dtype == torch.float32 \
            else 2e-2 * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.3e}"


# (q shape, kv shape, causal, window, id bounds, unmatched q id, starts)
MASK_CASES = [
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), True, 64, None, False,
                 None, id="window64"),
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), True, 200, None, False,
                 None, id="window200"),
    pytest.param((1, 4, 100, 64), (1, 2, 200, 64), True, 50, None, False,
                 None, id="window-decode-offset"),
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), True, None, (37, 150),
                 True, None, id="ids-causal"),
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), False, None, (37, 150),
                 True, None, id="ids-noncausal"),
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), True, None, (96, 200),
                 False, (0, 96, 200), id="ids-starts"),
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), True, 64, (37, 200),
                 False, None, id="window-ids"),
]


@pytest.mark.parametrize("path", ["fused", "split"])
@pytest.mark.parametrize(
    "q_shape,kv_shape,causal,window,bounds,unmatched,starts", MASK_CASES)
def test_matches_flash_attention_bwd(monkeypatch, path, q_shape, kv_shape,
                                     causal, window, bounds, unmatched,
                                     starts):
    if path == "split":
        monkeypatch.setattr(JFB, "_FUSED_SCRATCH_LIMIT", 0)
    segs = None
    if bounds is not None:
        kv_seg = _ids(q_shape[0], kv_shape[2], bounds)
        q_seg = kv_seg[:, :q_shape[2]].copy()
        if unmatched:
            q_seg[0, 5] = -7                  # matches no kv column
        segs = (q_seg, kv_seg)
    sc = q_shape[-1] ** -0.5
    targs, jargs, jsegs = _inputs(q_shape, kv_shape, torch.float32, 41,
                                  causal=causal, window=window, segs=segs)
    want = JFB.flash_attention_bwd(
        *jargs, causal=causal, sm_scale=sc, segment_ids=jsegs,
        window=window, block_q=128, block_kv=128, interpret=True,
        segment_starts=starts)
    tsegs = None if segs is None else tuple(torch.from_numpy(s)
                                            for s in segs)
    got = flash_attention_bwd(*targs, causal=causal, sm_scale=sc,
                              segment_ids=tsegs, window=window,
                              segment_starts=starts)
    _check(got, want, torch.float32)
    if unmatched:
        assert torch.all(got[0][0, :, 5] == 0)


def test_matches_flash_attention_bwd_bf16():
    """bf16 with a window and ids, on JAX's fused path."""
    kv_seg = _ids(1, 256, (37, 200))
    targs, jargs, jsegs = _inputs((1, 4, 256, 64), (1, 2, 256, 64),
                                  torch.bfloat16, 43, causal=True,
                                  window=64, segs=(kv_seg, kv_seg))
    want = JFB.flash_attention_bwd(*jargs, causal=True, sm_scale=0.125,
                                   segment_ids=jsegs, window=64,
                                   block_q=128, block_kv=128, interpret=True)
    tsegs = (torch.from_numpy(kv_seg),) * 2
    got = flash_attention_bwd(*targs, causal=True, sm_scale=0.125,
                              segment_ids=tsegs, window=64)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _check(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("causal,window,bounds", [
    pytest.param(True, 24, None, id="window"),
    pytest.param(True, None, (17, 60), id="ids-causal"),
    pytest.param(False, None, (17, 60), id="ids-noncausal"),
    pytest.param(True, 20, (17, 60), id="window-ids"),
])
def test_masked_autograd_matches_autograd_through_plain(causal, window,
                                                        bounds, dtype):
    """flash_attention's autograd Function with the masks (its backward is
    flash_attention_bwd) against torch autograd through the plain forward.
    Gates: f32 2e-5, bf16 2e-2 and fp16 1e-2 of the largest |gradient|."""
    rng = np.random.default_rng(37)
    shapes = ((2, 4, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64))
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(dtype).requires_grad_() for s in shapes]
    w = torch.from_numpy(rng.standard_normal(shapes[0]).astype(np.float32))
    masks = {"window": window}
    if bounds is not None:
        seg = torch.from_numpy(_ids(2, 96, bounds))
        masks["segment_ids"] = (seg, seg)
    out = flash_attention(*leaves, causal=causal, **masks)
    assert out.dtype == dtype
    fn = out.grad_fn
    while "FlashAttention" not in type(fn).__name__:   # fp16: a cast first
        fn = fn.next_functions[0][0]
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    plain_in = [t.float() if dtype == torch.float16 else t for t in leaves]
    ref = flash_attention_plain(*plain_in, causal=causal,
                                sm_scale=64 ** -0.5, **masks).to(dtype)
    want = torch.autograd.grad((ref.float() * w).sum(), leaves)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        scale = float(r.float().abs().max())
        atol = {torch.float32: 2e-5, torch.bfloat16: 2e-2 * scale,
                torch.float16: 1e-2 * scale}[dtype]
        err = float((g.float() - r.float()).abs().max())
        assert err <= atol, f"{name}: {err:.3e} > {atol:.3e}"


def _live(q_len, kv_len, causal, window, starts, bq, bkv):
    """(q tile, kv tile) pairs holding at least one visible pair."""
    pos = np.arange(q_len)[:, None] + kv_len - q_len
    cols = np.arange(kv_len)[None, :]
    vis = np.ones((q_len, kv_len), bool)
    if causal:
        vis &= cols <= pos
        if window is not None:
            vis &= cols >= pos - window + 1
    if starts is not None:
        table = np.asarray(sorted({0, *starts}))
        seg = np.searchsorted(table, np.arange(q_len), side="right")
        vis &= seg[:, None] == seg[None, :]
    rows, cols = np.nonzero(vis)
    return set(zip((rows // bq).tolist(), (cols // bkv).tolist()))


TILE_CASES = [
    (256, 256, True, None, None),
    (1024, 1024, True, 200, None),
    (300, 700, True, 100, None),           # the decode offset
    (700, 300, True, None, None),          # rows that see nothing
    (256, 384, False, None, None),
    (640, 640, True, None, (96, 200, 333)),
    (640, 640, False, None, (96, 200, 333)),
    (640, 640, True, 150, (96, 200, 333)),
]


@pytest.mark.parametrize("q_len,kv_len,causal,window,starts", TILE_CASES)
def test_tile_tables_cover_the_live_work_lists(q_len, kv_len, causal,
                                               window, starts):
    """Every live (q tile, kv tile) pair is in the backward's kv-major and
    q-major tables, at JAX's 128 x 128 tiles and at the bf16 and f32
    kernels' own; at 128 x 128 every pair of a table is in JAX's work
    list; each table is ordered longest range first."""
    def tables(bm, bn):
        kv_t, q_t = bwd_tiles(q_len, kv_len, causal=causal, window=window,
                              segment_starts=starts, block_m=bm, block_n=bn)
        for t in (kv_t, q_t):
            spans = (t[1] - t[0])[t[2]]
            assert sorted(t[2].tolist()) == list(range(t.shape[1]))
            assert bool(np.all(np.diff(spans) <= 0))
        mine_kv = {(qi, kvi) for kvi, (lo, hi) in enumerate(zip(*kv_t[:2]))
                   for qi in range(lo, hi)}
        mine_q = {(qi, kvi) for qi, (lo, hi) in enumerate(zip(*q_t[:2]))
                  for kvi in range(lo, hi)}
        live = _live(q_len, kv_len, causal, window, starts, bm, bn)
        assert live <= mine_kv, (bm, bn)
        assert live <= mine_q, (bm, bn)
        return mine_kv, mine_q

    for cfg in (FLASH_BWD_BF16, FLASH_BWD_F32):
        tables(cfg.block_m, cfg.block_n)
    b = 128
    mine_kv, mine_q = tables(b, b)
    n_q, n_kv = -(-q_len // b), -(-kv_len // b)
    jstarts = None if starts is None else (0, *starts)
    kvis, qis, _ = JFB._build_bwd_worklist(n_q, n_kv, b, b, q_len, kv_len,
                                           causal, window, jstarts)
    jax_kv = set(zip(qis.tolist(), kvis.tolist()))
    qis, kvis, _ = JFB._build_bwd_worklist_qmajor(
        n_q, n_kv, b, b, q_len, kv_len, causal, window, jstarts)
    jax_q = set(zip(qis.tolist(), kvis.tolist()))
    assert mine_kv <= jax_kv
    assert mine_q <= jax_q


@pytest.mark.parametrize("q_len,kv_len,causal,window,starts",
                         TILE_CASES + [(8192, 8192, True, None, None),
                                       (2048, 2048, True, 1024, None)])
def test_dq_chain_orders_each_q_tile_by_rank(q_len, kv_len, causal, window,
                                             starts):
    """The bf16 kernels add each q tile's dQ contributions in a chain: the
    kv tiles that see q tile i are numbered 0..n-1 in the rank order of the
    table (the order in which their blocks are numbered and dispatched),
    so a block waits only on blocks of lower rank; each q tile's chain
    length is its number of links (its last link resets the counter)."""
    cfg = FLASH_BWD_BF16
    kv_t, _ = bwd_tiles(q_len, kv_len, causal=causal, window=window,
                        segment_starts=starts, block_m=cfg.block_m,
                        block_n=cfg.block_n)
    base, pos, length = dq_chain(kv_t)
    lo, hi, order = kv_t
    assert base.dtype == pos.dtype == length.dtype == np.int32
    assert pos.size == int(np.maximum(hi - lo, 0).sum())
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    chains = {}
    for j in range(order.size):
        for i, qt in enumerate(range(lo[j], hi[j])):
            chains.setdefault(qt, []).append((rank[j], pos[base[j] + i]))
    for qt, links in chains.items():
        links.sort()
        assert [p for _, p in links] == list(range(len(links))), qt
    assert length.size == max(int(hi.max()), 0)
    assert all(int(length[qt]) == len(chains.get(qt, ()))
               for qt in range(length.size))


def test_forward_only_raises_at_backward():
    """The Function that wraps the CUDA entries without a JAX VJP: its
    backward raises NotImplementedError naming the entry; with grad off,
    or no input that requires grad, the launch runs without it."""
    x = torch.randn(3, 4, requires_grad=True)
    out = forward_only("the entry", lambda: x.detach() * 2, x)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="the entry.*as in JAX"):
        out.sum().backward()
    with torch.no_grad():
        assert forward_only("the entry", lambda: x * 2, x).grad_fn is None
    y = torch.randn(3, 4)
    assert forward_only("the entry", lambda: y * 2, y).grad_fn is None
