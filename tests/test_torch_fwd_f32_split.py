"""The f32 forward's work list and run merge, on the CPU.

The f32 forward kernel (csrc/flash_fwd.cuh's f32 body) cuts each 128-row q
tile's kv range, as `fwd_f32_tiles` clamps it (causal with the decode
offset, the window's band, `segment_starts`), at the multiples of a
FlashConfig's `f32_split` kv tiles into runs (`fwd_f32_work`), one block per
(run, q head, batch), longest first; the last run of a tile to arrive
merges the tile's runs in run order with the exact LSE combine. Held here:

  * each tile's runs cover its range exactly, in order, each within one
    aligned run of the split; every pair `visible_mask` lets through lies
    in a run of its q tile; the blocks take the runs longest first; at the
    f32 train step's (1, 8, 1024) causal the configured split gives at
    least 128 blocks (one block per 64-row q tile gave 128 of very unequal
    length);
  * the run length comes from the shape (`fwd_f32_split`): no split where
    the q tiles fill two waves, and never more merge slots than
    FLASH_FWD_F32_MAX_SLOTS (the workspace's bound) at long lengths; the
    slots number only the items of tiles that split (`fwd_f32_slots`);
  * `f32_split_merge_plain`, the kernel's run layout and merge order in
    plain PyTorch, against the port's plain forward and the JAX package's
    `flash_attention` in f32 (its XLA route at these lengths, its Pallas
    kernels in interpret mode with `segment_starts`), at GQA groups 1, 2,
    4 and 8, causal with and without the decode offset, rows before every
    column, the window, segment ids, segment_starts and non-causal, at the
    configured split and at splits short enough that these lengths'
    ranges split. Gates: 2e-6 against the port's plain version (the same
    f32 products summed in another order and merged: a few f32 ulps of
    out, whose entries are O(1), and of the LSE, up to about 7 here),
    1e-5 against JAX (its own order and exp; the f32 gate of
    utils/testing.py is 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops.configs import FlashConfig
from tiny_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from tiny_flash_attention_tpu_torch.ops import configs
from tiny_flash_attention_tpu_torch.ops.configs import FLASH_FWD_F32
from tiny_flash_attention_tpu_torch.ops.configs import (
    FlashConfig as PortConfig)
from tiny_flash_attention_tpu_torch.ops.flash import (
    f32_split_merge_plain, flash_attention_plain, fwd_f32_slots,
    fwd_f32_split, fwd_f32_tiles, fwd_f32_work, visible_mask)

BM, BN = FLASH_FWD_F32.block_m, FLASH_FWD_F32.block_n
INTERP = FlashConfig(block_q=128, block_kv=128, interpret=True)
# the port's default config and its runs (5 kv tiles)
DEFAULT = PortConfig()
FLASH_FWD_F32_SPLIT = DEFAULT.f32_split


def _ids(b, n, bounds):
    ids = np.zeros((b, n), np.int32)
    for x in bounds:
        ids[:, x:] += 1
    return ids


# (q_len, kv_len, causal, window, segment starts)
WORK_CASES = [(1024, 1024, True, None, None), (1024, 1024, True, 256, None),
              (300, 700, True, 100, None), (700, 300, True, None, None),
              (333, 97, False, None, None), (640, 640, True, None,
                                              (96, 200, 333)),
              (1, 900, True, None, None), (900, 900, True, 300, (450,)),
              (2048, 2048, True, None, None)]


@pytest.mark.parametrize("split", [1, 3, FLASH_FWD_F32_SPLIT])
@pytest.mark.parametrize("q_len,kv_len,causal,window,starts", WORK_CASES)
def test_runs_cover_each_range_once(q_len, kv_len, causal, window, starts,
                                    split):
    table = fwd_f32_tiles(q_len, kv_len, causal=causal, window=window,
                          starts=starts)
    flat, m = fwd_f32_work(q_len, kv_len, causal=causal, window=window,
                           starts=starts, split=split)
    tile, lo, hi, order = flat[:4 * m].reshape(4, m)
    first = flat[4 * m:]
    n = -(-q_len // BM)
    assert table.shape == (3, n)
    assert first.size == n + 1 and first[0] == 0 and first[-1] == m
    for t in range(n):
        its = range(first[t], first[t + 1])
        assert len(its) >= 1 and all(tile[i] == t for i in its)
        t_lo, t_hi = int(table[0, t]), int(table[1, t])
        assert 0 <= t_lo < t_hi <= -(-kv_len // BN)
        runs = [(int(lo[i]), int(hi[i])) for i in its]
        assert runs[0][0] == t_lo and runs[-1][1] == t_hi
        assert all(a < b and (b - 1) // split == a // split for a, b in runs)
        assert all(a % split == 0 for a, _ in runs[1:])
        assert all(x[1] == y[0] for x, y in zip(runs, runs[1:]))
    assert sorted(order.tolist()) == list(range(m))
    assert (np.diff((hi - lo)[order]) <= 0).all()
    # every visible pair lies in its q tile's range
    ids = None
    if starts is not None:
        t_ids = torch.from_numpy(_ids(1, q_len, starts))
        ids = (t_ids, t_ids)
    vis = visible_mask(q_len, kv_len, "cpu", causal=causal, window=window,
                       segment_ids=ids)
    if vis is not None:
        rows, cols = np.nonzero(vis.reshape(q_len, kv_len).numpy())
        assert (table[0, rows // BM] <= cols // BN).all()
        assert (cols // BN < table[1, rows // BM]).all()


@pytest.mark.parametrize("split,blocks", [(1, 576), (2, 288), (3, 216),
                                          (4, 160), (5, 144), (6, 120),
                                          (8, 96), (16, 64)])
def test_runs_fill_the_card_at_the_f32_train_shape(split, blocks):
    """(1, 8, 1024) causal: q tile i of 128 rows walks kv tiles 0 .. 2i + 1,
    so runs of at most S tiles give these many blocks over the 8 heads;
    the configured split gives at least 128 on the H100's 132 SMs."""
    assert fwd_f32_work(1024, 1024, causal=True, split=split)[1] * 8 \
        == blocks
    assert fwd_f32_split(1024, 1024, causal=True, n_bh=8, config=DEFAULT) \
        == FLASH_FWD_F32_SPLIT
    assert fwd_f32_work(1024, 1024, causal=True, n_bh=8)[1] * 8 >= 128


@pytest.mark.parametrize("q_len,kv_len,causal,window,starts", WORK_CASES)
def test_slots_number_the_items_of_split_tiles(q_len, kv_len, causal,
                                               window, starts):
    """Each item of a tile of several runs has a slot of its own, in item
    order; a tile of one run has none (-1)."""
    for split in (1, 3, FLASH_FWD_F32_SPLIT):
        flat, m = fwd_f32_work(q_len, kv_len, causal=causal, window=window,
                               starts=starts, split=split)
        slots, n_slots = fwd_f32_slots(flat, m)
        first = flat[4 * m:]
        want, nxt = [], 0
        for t in range(first.size - 1):
            runs = int(first[t + 1] - first[t])
            if runs == 1:
                want.append(-1)
            else:
                want += range(nxt, nxt + runs)
                nxt += runs
        assert slots.dtype == np.int32 and slots.tolist() == want
        assert n_slots == nxt


# (batch x q heads, q_len, kv_len, causal): the f32 train step's shape, the
# int8 bench shape, long causal and non-causal lengths, a chunk of 4096 q
# rows over a 32768-token cache, many heads
SPLIT_SHAPES = [(8, 1024, 1024, True), (16, 2048, 2048, True),
                (8, 8192, 8192, True), (8, 4096, 32768, True),
                (8, 32768, 32768, False), (1, 32768, 32768, True),
                (1, 128, 131072, False), (64, 1024, 1024, True),
                (2, 300, 700, True), (8, 1, 900, True)]


@pytest.mark.parametrize("n_bh,q_len,kv_len,causal", SPLIT_SHAPES)
def test_split_bounds_the_workspace(n_bh, q_len, kv_len, causal):
    """The run length `fwd_f32_split` takes from the shape: where the q
    tiles give at least FLASH_FWD_F32_SPLIT_BELOW blocks, one run a tile
    (no slots, no workspace); else at least FLASH_FWD_F32_SPLIT tiles, the
    least whose slots over the batch and heads stay within
    FLASH_FWD_F32_MAX_SLOTS, so the merge's workspace stays under
    FLASH_FWD_F32_MAX_SLOTS x 128 x (D + 2) f32 whatever the length; a
    window or segment_starts only shortens the ranges and needs no more."""
    split = fwd_f32_split(q_len, kv_len, causal=causal, n_bh=n_bh,
                          config=DEFAULT)
    n_tiles, n_kv = -(-q_len // BM), -(-kv_len // BN)
    cap = configs.FLASH_FWD_F32_MAX_SLOTS
    for window, starts in ((None, None), (q_len // 3 + 1, None),
                           (None, (0, q_len // 2)) if q_len == kv_len
                           else (None, None)):
        if window is not None and not causal:
            continue
        flat, m = fwd_f32_work(q_len, kv_len, causal=causal, window=window,
                               starts=starts, n_bh=n_bh)
        _, n_slots = fwd_f32_slots(flat, m)
        assert n_slots * n_bh <= cap
        if n_tiles * n_bh >= configs.FLASH_FWD_F32_SPLIT_BELOW:
            assert split >= n_kv and n_slots == 0 and m == n_tiles
    assert split >= FLASH_FWD_F32_SPLIT
    if split > FLASH_FWD_F32_SPLIT and n_tiles * n_bh \
            < configs.FLASH_FWD_F32_SPLIT_BELOW:
        # the least such split: one tile shorter needs too many slots
        flat, m = fwd_f32_work(q_len, kv_len, causal=causal,
                               split=split - 1)
        assert fwd_f32_slots(flat, m)[1] * n_bh > cap
    assert n_slots * n_bh * BM * (128 + 2) * 4 <= 71 * 2 ** 20


def _inputs(hq, hkv, q_len, kv_len, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((1, hq, q_len, d), (1, hkv, kv_len, d),
                      (1, hkv, kv_len, d))]


# (hq, hkv, q_len, kv_len, causal, window, id bounds, starts)
MERGE_CASES = [
    pytest.param(4, 4, 300, 300, True, None, None, False, id="g1-causal"),
    pytest.param(4, 2, 333, 333, True, 100, None, False, id="g2-window"),
    pytest.param(8, 2, 130, 333, True, None, None, False, id="g4-offset"),
    pytest.param(8, 1, 300, 300, True, None, (37, 100, 250), True,
                 id="g8-ids-starts"),
    pytest.param(4, 1, 300, 97, True, None, None, False, id="g4-empty-rows"),
    pytest.param(4, 2, 297, 297, False, None, (130,), False,
                 id="g2-ids-noncausal"),
    pytest.param(8, 2, 300, 300, True, 70, (37, 200), True,
                 id="g4-window-ids-starts"),
    pytest.param(2, 1, 1, 450, True, None, None, False, id="g2-decode-row"),
]


@pytest.mark.parametrize("hq,hkv,q_len,kv_len,causal,window,bounds,starts",
                         MERGE_CASES)
def test_split_merge_matches_plain_and_jax(hq, hkv, q_len,
                                           kv_len, causal, window, bounds,
                                           starts):
    d, sc = 64, 64 ** -0.5
    q, k, v = _inputs(hq, hkv, q_len, kv_len, d, 7)
    segs = None
    if bounds is not None:
        seg = _ids(1, kv_len, bounds)
        segs = (seg[:, :q_len].copy(), seg)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tsegs = None if segs is None else tuple(torch.from_numpy(s)
                                            for s in segs)
    st = (0, *bounds) if starts else None
    plain = flash_attention_plain(tq, tk, tv, causal=causal, sm_scale=sc,
                                  segment_ids=tsegs, window=window,
                                  return_lse=True)
    jsegs = None if segs is None else tuple(jnp.asarray(s) for s in segs)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, sm_scale=sc, segment_ids=jsegs,
                     window=window, segment_starts=st, return_lse=True,
                     config=INTERP if starts else None)
    # the configured runs, and runs short enough that these lengths split
    for split in sorted({1, 2, FLASH_FWD_F32_SPLIT}):
        got = f32_split_merge_plain(tq, tk, tv, causal=causal, sm_scale=sc,
                                    segment_ids=tsegs, window=window,
                                    segment_starts=st,
                                    config=PortConfig(f32_split=split))
        for name, g, p, w in zip(("out", "lse"), got, plain, want):
            assert g.dtype == torch.float32 and g.shape == p.shape
            assert float((g - p).abs().max()) <= 2e-6, (split, name)
            w = np.asarray(w)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-5, (split, name)
