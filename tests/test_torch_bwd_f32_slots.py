"""The f32 backward's work lists and slot sums, on the CPU.

The f32 kernels (csrc/flash_bwd.cu) cut each 64-row tile's range of the
other side's tiles at the multiples of FLASH_BWD_F32_SPLIT into runs
(`f32_work`), one block per (run, q head, batch), each writing a slot of
its own; the postprocess sums a tile's runs in range order and, for dk and
dv, the GQA group's q heads in head order. Held here:

  * each tile's runs cover its range of `bwd_tiles` exactly, in order,
    each within one aligned run of the split; a tile no one sees is one
    empty item; the blocks take the items longest first;
  * `f32_slot_sums_plain`, that layout and order in plain PyTorch, against
    the port's plain backward and the JAX package's `flash_attention_bwd`
    on its split path (the dq and dk/dv kernels this ports, in interpret
    mode), in f32 at GQA groups 1, 2, 4 and 8, causal with the decode
    offset and without, the window, segment ids and segment_starts, at
    the configured split and at splits short enough that these lengths'
    ranges split. Gates: 2e-6 against the port's plain
    version (f32 sums in another order), 1e-5 against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_flash_attention_tpu.ops.flash_bwd as JFB
from tiny_flash_attention_tpu.ops.flash import _xla_attention
from tiny_flash_attention_tpu_torch.ops import configs
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_BWD_F32, FLASH_BWD_F32_SPLIT)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    bwd_tiles, f32_slot_sums_plain, f32_work, flash_attention_bwd_plain)

T = FLASH_BWD_F32.block_m


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
              (1, 900, True, None, None), (900, 900, False, 300, None)]


@pytest.mark.parametrize("q_len,kv_len,causal,window,starts", WORK_CASES)
def test_work_lists_cover_each_range_once(q_len, kv_len, causal, window,
                                          starts):
    if window is not None and not causal:
        window = None
    for table in bwd_tiles(q_len, kv_len, causal=causal, window=window,
                           segment_starts=starts, block_m=T, block_n=T):
        flat, m = f32_work(table)
        tile, lo, hi, order = flat[:4 * m].reshape(4, m)
        first = flat[4 * m:]
        n = table.shape[1]
        assert first.size == n + 1 and first[0] == 0 and first[-1] == m
        assert (np.diff(first) >= 1).all()
        for t in range(n):
            its = range(first[t], first[t + 1])
            assert all(tile[i] == t for i in its)
            t_lo, t_hi = int(table[0, t]), int(table[1, t])
            if t_hi <= t_lo:
                assert len(its) == 1 and lo[its[0]] == hi[its[0]] == 0
                continue
            runs = [(int(lo[i]), int(hi[i])) for i in its]
            assert runs[0][0] == t_lo and runs[-1][1] == t_hi
            assert all(a < b and (b - 1) // FLASH_BWD_F32_SPLIT
                       == a // FLASH_BWD_F32_SPLIT for a, b in runs)
            assert all(a % FLASH_BWD_F32_SPLIT == 0 for a, _ in runs[1:])
            assert all(x[1] == y[0] for x, y in zip(runs, runs[1:]))
        assert sorted(order.tolist()) == list(range(m))
        spans = (hi - lo)[order]
        assert (np.diff(spans) <= 0).all()


@pytest.mark.parametrize("split,items", [(1, 136), (4, 40), (8, 24),
                                         (16, 16)])
def test_work_list_fills_the_card_at_the_f32_train_shape(split, items):
    """(1, 8, 1024) causal, 16 tiles a side: kv tile j sees q tiles j..15
    (and q tile i kv tiles 0..i), so runs cut at the multiples of 8 give 24
    items a head each way, 192 blocks a kernel on the H100's 132 SMs (one
    block a (kv tile, kv head) gave 32)."""
    kv_t, q_t = bwd_tiles(1024, 1024, causal=True, window=None,
                          segment_starts=None, block_m=T, block_n=T)
    assert f32_work(kv_t, split)[1] == items
    assert f32_work(q_t, split)[1] == items
    if split == FLASH_BWD_F32_SPLIT:
        assert f32_work(kv_t)[1] * 8 == 192


def _inputs(q_shape, kv_shape, seed, *, causal, window, segs):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape, q_shape)]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    jsegs = None if segs is None else tuple(jnp.asarray(s) for s in segs)
    jout, jlse = _xla_attention(jq, jk, jv, jsegs, causal,
                                q_shape[-1] ** -0.5, True, window)
    jax_args = (jq, jk, jv, jout, jlse, jdo)
    return tuple(torch.from_numpy(np.array(a)) for a in jax_args), \
        jax_args, jsegs


# (hq, hkv, q_len, kv_len, causal, window, id bounds, starts)
SLOT_CASES = [
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
]


@pytest.mark.parametrize("hq,hkv,q_len,kv_len,causal,window,bounds,starts",
                         SLOT_CASES)
def test_slot_sums_match_plain_and_jax(monkeypatch, hq, hkv, q_len, kv_len,
                                       causal, window, bounds, starts):
    monkeypatch.setattr(JFB, "_FUSED_SCRATCH_LIMIT", 0)   # the split path
    d, sc = 64, 64 ** -0.5
    segs = None
    if bounds is not None:
        seg = _ids(1, kv_len, bounds)
        segs = (seg[:, :q_len].copy(), seg)
    targs, jargs, jsegs = _inputs((1, hq, q_len, d), (1, hkv, kv_len, d), 7,
                                  causal=causal, window=window, segs=segs)
    tsegs = None if segs is None else tuple(torch.from_numpy(s)
                                            for s in segs)
    st = (0, *bounds) if starts else None
    plain = flash_attention_bwd_plain(*targs, causal=causal, sm_scale=sc,
                                      segment_ids=tsegs, window=window)
    want = JFB.flash_attention_bwd(
        *jargs, causal=causal, sm_scale=sc, segment_ids=jsegs,
        window=window, block_q=128, block_kv=128, interpret=True,
        segment_starts=st)
    # the configured runs, and runs short enough that these lengths split
    for split in sorted({2, 3, configs.FLASH_BWD_F32_SPLIT}):
        monkeypatch.setattr(configs, "FLASH_BWD_F32_SPLIT", split)
        got = f32_slot_sums_plain(*targs, causal=causal, sm_scale=sc,
                                  segment_ids=tsegs, window=window,
                                  segment_starts=st)
        for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
            assert g.dtype == torch.float32 and g.shape == p.shape
            scale = float(p.abs().max())
            assert float((g - p).abs().max()) <= 2e-6 * scale, (split, name)
            w = np.asarray(w)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-5, (split, name)
