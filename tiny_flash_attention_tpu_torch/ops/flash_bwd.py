"""Flash-attention backward: the public entry, its plain version, its kernels.

Counterpart of the JAX package's five backward entry points, which compute
one contract and differ only in TPU scheduling:
`ops/flash_tri_bwd.py::tri_flash_bwd` and `::tri_flash_bwd_banded`,
`ops/flash_bwd.py::_flash_bwd_fused` and `::flash_attention_bwd` (its split
dq and dk/dv kernels). One Hopper source, csrc/flash_bwd.cu, ports all five:
in bf16 as one pass (a preprocess, the wgmma/TMA main kernel, a
postprocess), in f32 as the split form (a dq and a dk/dv kernel over work
lists that split each tile's range, `f32_work`, into slots of their own,
and a postprocess that sums the slots). Both take the masks of JAX's
`flash_attention_bwd`: the sliding window, segment ids and static
`segment_starts`. A CPU tensor takes the plain version; a CUDA tensor
takes the kernels or raises for what they do not do (quantized K/V;
head_dim above 256 in f32, ROADMAP queue B-dims-2a-f32-train, though the
f32 forward takes head dims to 512; above 512, B-dims-2a-512+). The bf16 kernels read q, k, v, out and do and write dq,
dk and dv at any head_dim that is a multiple of 8 up to 512 in place
(JAX pads its backward to 128 lanes; the kernels' tiles take TMA's zeros
past the true head_dim instead; above 128 the wide main kernel, over
64-row kv tiles; above 256 the main kernel of width 512, two blocks a kv
tile, one for each 256-column half of the gradients, over 32-row q
steps); other head dims, and the f32 kernels' (64, 128 and, over 32-row
tiles, 256), run padded with zero columns to the next tile width (512
above 256), the gradients sliced back (ops/dims.py::flash_head_dim).
There is no fallback from the card to the plain version.

Which tiles the kernels visit comes from `bwd_tiles`, a table built on the
host as JAX's work lists are (`_build_bwd_worklist` and its q-major twin):
causal, window and `segment_starts` clamp each tile's range; they prune
work and change no result.

Two runs give bit-identical gradients (the TPU walks its grid in one
order): the kernels sum in an order fixed by the shape and the masks. bf16
dK and dV: one f32 slot per q head, summed over the GQA group in head order
by the postprocess; dQ: each q tile's contributions are added in a chain,
in the kv tiles' rank order (`dq_chain`), each block waiting on a counter
for its turn; the last link of a chain sets the counter back to 0. f32: one
slot per (work item, q head) for each of dq, dk and dv; the postprocess
sums a tile's items in range order and, for dk and dv, the GQA group's q
heads in head order (`f32_slot_sums_plain` is the plain version of that
layout and order).

The rounding points are the work-list kernels' (flash_bwd.py:173): the
scale sm_scale * log2(e) is folded into q in the input dtype before the
q k^T product, so the recomputed p matches the LSE that the forward kernel
wrote with the same fold. The tensor cores then take p and ds rounded to the
input dtype and accumulate in f32; dq, dk and dv round once at the write.
The plain version repeats these points, so the card holds the kernels to it
tightly. (The tri kernels scale the f32 scores after the product instead,
flash_tri_bwd.py:185-197; the CPU tests hold both to the bf16 gate.)
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.configs import (
    FlashConfig, bwd_config, bwd_f32_config, bwd_f32_smem_bytes,
    bwd_f32_split, bwd_smem_bytes, resolve_config)
from tiny_flash_attention_tpu_torch.ops.dims import (
    FLASH_HEAD_DIMS, WIDE_HEAD_DIM, WIDER_HEAD_DIM, flash_head_dim,
    pad_head_dim, unpad_head_dim)
from tiny_flash_attention_tpu_torch.ops.flash import (
    LOG2E, _KERNEL_DTYPES, _aligned, as_int32, in_dtype, run_work,
    visible_mask)
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool,
                        sm_scale: Optional[float] = None, segment_ids=None,
                        window: Optional[int] = None, segment_starts=None,
                        config: Optional[FlashConfig] = None):
    """Gradients of flash attention: returns (dq, dk, dv).

    Args:
      q, out, do: (batch, q_heads, q_len, head_dim)
      k, v: (batch, kv_heads, kv_len, head_dim); q_heads % kv_heads == 0
      lse: the forward's natural-log LSE (batch, q_heads, q_len) f32
      causal: row i sits at position i + kv_len - q_len (decode offset)
      sm_scale: softmax scale, default 1/sqrt(head_dim)
      segment_ids: optional (q_seg (b, q_len), kv_seg (b, kv_len)) int
        pair, the forward's: only equal ids attend
      window: optional sliding window (causal): the row at position p sees
        columns [p - window + 1, p]
      segment_starts: static segment offsets of a packed row (q_len ==
        kv_len, with segment_ids): on CUDA they prune the tiles; no result
        changes
      config: the forward's (ops/configs.py::FlashConfig, default
        FlashConfig()): its narrow bf16 instances; checked before any
        launch, nothing on the CPU

    dq is like q; dk and dv are like k, summed over each kv head's group of
    q heads. `do` is cast to q's dtype, as the JAX tri kernels do.
    """
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA needs q_heads {hq} % kv_heads {hkv} == 0")
    if v.shape != k.shape or out.shape != q.shape or do.shape != q.shape \
            or lse.shape != (bs, hq, q_len):
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape} out "
                         f"{out.shape} lse {lse.shape} do {do.shape}")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window {window} needs causal=True and >= 1")
    if segment_starts is not None and (segment_ids is None
                                       or q_len != kv_len):
        raise ValueError("segment_starts needs segment_ids and q_len == "
                         "kv_len")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    config = resolve_config(config)
    do = do.to(q.dtype)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                               sm_scale=sm_scale, segment_ids=segment_ids,
                               window=window, segment_starts=segment_starts,
                               config=config)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                     sm_scale=sm_scale,
                                     segment_ids=segment_ids, window=window)


# calls that launched the kernels, counted by _flash_bwd_cuda; a bf16 call
# launches flash_bwd_prep, flash_bwd_main and flash_bwd_post once each, an
# f32 call the dq, the dk/dv and the post kernel once each
flash_attention_bwd.launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool,
                              sm_scale: float, segment_ids=None,
                              window: Optional[int] = None):
    """Plain PyTorch backward with the kernels' arithmetic and rounding
    points (the FA2 identities of flash_bwd.py:9-15) and masks
    (`_recompute_p`, flash_bwd.py:158-203: masked scores take the mask
    value, p is 0 on rows whose LSE is the empty-row sentinel). Runs on
    any device; materializes the (q_len, kv_len) scores of every head, and
    frees each such tensor once it is used (at 8 heads of 8192 each is
    2.1 GB)."""
    bs, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    group = hq // hkv
    dt = q.dtype
    kr = k.repeat_interleave(group, dim=1) if group > 1 else k
    vr = v.repeat_interleave(group, dim=1) if group > 1 else v
    qs = (q * in_dtype(sm_scale * LOG2E, dt)).to(dt)
    s2 = torch.matmul(qs.float(), kr.float().transpose(-1, -2))
    valid = visible_mask(q_len, kv_len, q.device, causal=causal,
                         window=window, segment_ids=segment_ids)
    if valid is not None:
        s2 = torch.where(valid, s2, DEFAULT_MASK_VALUE)
    lse2 = lse.float()[..., None] * LOG2E
    # rows that saw no column carry the LSE sentinel; without the guard
    # their p would be exp2(MASK - MASK) = 1 (flash_bwd.py:197-202)
    p = torch.where(lse2 > 0.5 * DEFAULT_MASK_VALUE, torch.exp2(s2 - lse2),
                    0.0)
    del s2
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dp = torch.matmul(do.float(), vr.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).float()
    del dp
    p = p.to(dt).float()
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    del p
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, kr.float()) * sm_scale
    if group > 1:
        dk = dk.view(bs, hkv, group, kv_len, d).sum(2)
        dv = dv.view(bs, hkv, group, kv_len, d).sum(2)
    return dq.to(dt), (dk * sm_scale).to(dt), dv.to(dt)


# --- the tile tables -------------------------------------------------------


def _segments(starts, n: int):
    """(segment start of each position, segment end) lookups for static
    starts of a packed row of n tokens."""
    table = np.asarray(sorted({0, *(int(x) for x in starts)}), np.int64)
    if table[0] < 0 or table[-1] >= n:
        raise ValueError(f"segment_starts {tuple(starts)} outside [0, {n})")
    ends = np.append(table[1:], n)

    def start(pos):
        return table[np.searchsorted(table, pos, side="right") - 1]

    def end(pos):
        return ends[np.searchsorted(table, pos, side="right") - 1]

    return start, end


def bwd_tiles(q_len: int, kv_len: int, *, causal: bool,
              window: Optional[int], segment_starts, block_m: int,
              block_n: int):
    """The backward's tile tables, built on the host as JAX's work lists
    (`_build_bwd_worklist`, `_build_bwd_worklist_qmajor`): (kv, q), each a
    (3, n) int32 array of lo, hi, order.

    kv-major, one column per kv tile of block_n columns: its q tiles of
    block_m rows [lo, hi), the tiles of the first and the last row that see
    any of its columns (causal: the row at column kv0 - offset; a window:
    the row at its last column - offset + window - 1; static starts: the
    segments of its first and last column). q-major, one column per q tile:
    its kv tiles [lo, hi) by the same rules. An empty range (hi <= lo) is a
    tile no one sees: its gradient is 0. `order` lists the tiles longest
    range first, the order in which blocks take them."""
    offset = kv_len - q_len
    n_q, n_kv = -(-q_len // block_m), -(-kv_len // block_n)
    seg = None if segment_starts is None else _segments(segment_starts,
                                                        q_len)

    c0 = np.arange(n_kv, dtype=np.int64) * block_n
    c1 = np.minimum(c0 + block_n, kv_len) - 1
    r_lo = np.maximum(c0 - offset, 0) if causal else np.zeros_like(c0)
    r_hi = np.full_like(c0, q_len - 1)
    if window is not None:
        r_hi = np.minimum(r_hi, c1 - offset + window - 1)
    if seg is not None:
        r_lo = np.maximum(r_lo, seg[0](c0))
        r_hi = np.minimum(r_hi, seg[1](c1) - 1)
    kv_lo = r_lo // block_m
    kv_hi = np.where(r_lo <= r_hi, r_hi // block_m + 1, kv_lo)

    r0 = np.arange(n_q, dtype=np.int64) * block_m
    r1 = np.minimum(r0 + block_m, q_len) - 1
    k_lo = np.zeros_like(r0)
    k_hi = np.full_like(r0, kv_len - 1)
    if causal:
        k_hi = np.minimum(k_hi, r1 + offset)
    if window is not None:
        k_lo = np.maximum(k_lo, r0 + offset - window + 1)
    if seg is not None:
        k_lo = np.maximum(k_lo, seg[0](r0))
        k_hi = np.minimum(k_hi, seg[1](r1) - 1)
    q_lo = np.maximum(k_lo, 0) // block_n
    q_hi = np.where(k_lo <= k_hi, k_hi // block_n + 1, q_lo)

    def table(lo, hi):
        order = np.argsort(-(hi - lo), kind="stable")
        return np.stack([lo, hi, order]).astype(np.int32)

    return table(kv_lo, kv_hi), table(q_lo, q_hi)


def dq_chain(kv_table):
    """The order of the dQ sums: (base (n_kv,), pos (sum of ranges,),
    length (q tiles,)), int32. The blocks of a kv-major table add into the
    q tiles of their ranges; kv tile j's contribution to q tile lo[j] + i
    is number pos[base[j] + i] of that q tile's chain, counted in rank
    order (the order of `order`, in which blocks are numbered and
    dispatched), so a block waits only on blocks of lower rank. length[i]
    is the links of q tile i's chain: the last one resets the tile's
    counter for the next call."""
    lo, hi, order = (np.asarray(r, np.int64) for r in kv_table[:3])
    span = np.maximum(hi - lo, 0)
    base = np.concatenate([[0], np.cumsum(span)[:-1]])
    pos = np.zeros(int(span.sum()), np.int64)
    seen = np.zeros(int(max(hi.max(initial=0), 0)), np.int64)
    for j in order:
        qts = np.arange(lo[j], hi[j])
        pos[base[j] + qts - lo[j]] = seen[qts]
        seen[qts] += 1
    return base.astype(np.int32), pos.astype(np.int32), \
        seen.astype(np.int32)


def f32_work(table, split: Optional[int] = None, head_dim: int = 128):
    """The f32 kernels' work list from a (3, n) tile table (`bwd_tiles` at
    the tiles of the instance at head_dim): `run_work` at runs of `split`
    (default: ops/configs.py::bwd_f32_split, read at each call)."""
    return run_work(table, bwd_f32_split(head_dim) if split is None
                    else split)


def f32_slot_sums_plain(q, k, v, out, lse, do, *, causal: bool,
                        sm_scale: float, segment_ids=None,
                        window: Optional[int] = None, segment_starts=None):
    """The f32 kernels' slot layout and sum order in plain PyTorch: each
    work item of `f32_work` (of the tables at the tiles of the instance at
    q's head_dim, `bwd_f32_config`, with `segment_starts` pruning them)
    computes its q head's contribution from the pairs of its tile and its
    run of the other side's tiles into a slot of its own (a tile of f32,
    like the kernels'); dq sums its q tile's items in range order, dk and
    dv the GQA group's q heads in head order, each over its kv tile's
    items in range order. Returns
    (dq, dk, dv) in q's dtype. A pair outside every item would be lost and
    one in two counted twice, so this holds the work lists to the plain
    backward."""
    bs, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    group = hq // hkv
    t = bwd_f32_config(d).block_m
    kv_t, q_t = bwd_tiles(q_len, kv_len, causal=causal, window=window,
                          segment_starts=_starts_key(segment_starts),
                          block_m=t, block_n=t)
    dt = q.dtype
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    qs = (q * in_dtype(sm_scale * LOG2E, dt)).to(dt).float()
    valid = visible_mask(q_len, kv_len, q.device, causal=causal,
                         window=window, segment_ids=segment_ids)
    s2 = torch.matmul(qs, kr.transpose(-1, -2))
    if valid is not None:
        s2 = torch.where(valid, s2, DEFAULT_MASK_VALUE)
    lse2 = lse.float()[..., None] * LOG2E
    p = torch.where(lse2 > 0.5 * DEFAULT_MASK_VALUE, torch.exp2(s2 - lse2),
                    0.0)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do.float(), vr.transpose(-1, -2)) - delta)

    def sums(table, grad):
        """grad(tile rows, other-side columns) -> (bs, hq, t, d) slot for
        every item, summed per tile in range order."""
        flat, m = f32_work(table, head_dim=d)
        tiles, ilo, ihi, _ = flat[:4 * m].reshape(4, m)
        first = flat[4 * m:]
        res = []
        for tile in range(first.size - 1):
            acc = None
            for it in range(first[tile], first[tile + 1]):
                rows = slice(tiles[it] * t, (tiles[it] + 1) * t)
                cols = slice(ilo[it] * t, ihi[it] * t)
                slot = grad(rows, cols)
                acc = slot if acc is None else acc + slot
            res.append(acc)
        return torch.cat(res, dim=2)

    dq = sums(q_t, lambda r, c: torch.matmul(ds[:, :, r, c], kr[:, :, c]))
    dk_h = sums(kv_t, lambda r, c: torch.matmul(
        ds[:, :, c, r].transpose(-1, -2), q.float()[:, :, c]))
    dv_h = sums(kv_t, lambda r, c: torch.matmul(
        p[:, :, c, r].transpose(-1, -2), do.float()[:, :, c]))

    def group_sum(x):
        x = x.view(bs, hkv, group, kv_len, d)
        acc = x[:, :, 0]
        for g in range(1, group):
            acc = acc + x[:, :, g]
        return acc

    return ((dq * sm_scale).to(dt), (group_sum(dk_h) * sm_scale).to(dt),
            group_sum(dv_h).to(dt))


@functools.lru_cache(maxsize=64)
def _device_f32_work(q_len, kv_len, causal, window, starts, t, split,
                     device):
    """The f32 work lists at tiles of t rows on the device: (kv-major
    list, its items, q-major list, its items)."""
    kv_t, q_t = bwd_tiles(q_len, kv_len, causal=causal, window=window,
                          segment_starts=starts, block_m=t, block_n=t)
    (kv_w, kv_n), (q_w, q_n) = f32_work(kv_t, split), f32_work(q_t, split)
    both = torch.as_tensor(np.concatenate([kv_w, q_w]), device=device)
    return both[:kv_w.size], kv_n, both[kv_w.size:], q_n


@functools.lru_cache(maxsize=64)
def _device_tiles(q_len, kv_len, causal, window, starts, block_m, block_n,
                  device):
    """The tables on the device: kv-major (lo, hi, order, then
    `dq_chain`'s base, pos and length, flat) and q-major (3, n)."""
    kv_t, q_t = bwd_tiles(q_len, kv_len, causal=causal, window=window,
                          segment_starts=starts, block_m=block_m,
                          block_n=block_n)
    kv_flat = np.concatenate([kv_t.ravel(), *dq_chain(kv_t)])
    both = torch.as_tensor(np.concatenate([kv_flat, q_t.ravel()]),
                           device=device)
    return both[:kv_flat.size].contiguous(), \
        both[kv_flat.size:].view(3, -1).contiguous()


# --- the kernels -------------------------------------------------------------


def check_f32_smem(lib: ctypes.CDLL) -> None:
    """Holds `bwd_f32_smem_bytes` to the shared memory the library's f32
    kernels take (`tfa_flash_bwd_f32_smem`); raises where they differ."""
    smem = lib.tfa_flash_bwd_f32_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    for d in (*FLASH_HEAD_DIMS, WIDE_HEAD_DIM):
        if smem(d) != bwd_f32_smem_bytes(d):
            raise RuntimeError(
                f"ops/configs.py::bwd_f32_smem_bytes gives "
                f"{bwd_f32_smem_bytes(d)} bytes at head_dim {d}; the f32 "
                f"backward kernels take {smem(d)}")


def check_bf16_smem(lib: ctypes.CDLL) -> None:
    """Holds `bwd_smem_bytes` to the shared memory the library's bf16 main
    kernels take at every tile width, the wide one and that of width 512
    included (`tfa_flash_bwd_bf16_smem`); raises where they differ."""
    smem = lib.tfa_flash_bwd_bf16_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    for d in (*FLASH_HEAD_DIMS, WIDE_HEAD_DIM, WIDER_HEAD_DIM):
        if smem(d) != bwd_smem_bytes(d):
            raise RuntimeError(
                f"ops/configs.py::bwd_smem_bytes gives {bwd_smem_bytes(d)} "
                f"bytes at head_dim {d}; the bf16 backward's main kernel "
                f"takes {smem(d)}")


def _flash_bwd_fn():
    lib = _build.library("flash_bwd")
    fn = lib.tfa_flash_bwd
    if fn.argtypes is None:
        check_f32_smem(lib)
        check_bf16_smem(lib)
        fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, out, lse, do) -> None:
    bs, hq, q_len, d = q.shape
    kv_len = k.shape[2]
    if q.dtype not in _KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in (k, v, out, do)):
        raise NotImplementedError(
            f"the CUDA backward kernels take bf16 or f32 tensors of one "
            f"dtype (quantized K/V have no backward, as in JAX), got "
            f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}, {do.dtype}")
    dk = flash_head_dim(d, q.dtype, "the CUDA backward kernels",
                        backward=True)
    if dk != d:
        raise NotImplementedError(
            f"head_dim {d}: the CUDA {str(q.dtype).split('.')[-1]} backward "
            f"kernels take it padded to {dk} (flash_attention_bwd pads)")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32, got {lse.dtype}")
    if any(not t.is_cuda or t.device != q.device
           for t in (k, v, out, lse, do)):
        raise ValueError("q, k, v, out, lse and do must be on one CUDA "
                         "device")
    if q_len == 0 or kv_len == 0 or bs == 0:
        raise ValueError("empty q or kv")


def _starts_key(segment_starts):
    """Static starts as a hashable key."""
    if segment_starts is None:
        return None
    return tuple(sorted({0, *(int(x) for x in segment_starts)}))


class BwdLaunch:
    """One backward call, checked and allocated: `run(stages)` launches its
    kernels (bf16: 1 prep, 2 main, 4 post; f32: 1 dq, 2 dk/dv, 4 post), so
    that chip_smoke.py can time each alone. `grads` are (dq, dk, dv);
    `turns` the bf16 dQ chain's counters, which the main kernel leaves at
    0; `slots` the f32 kernels' (dq, dk, dv) slots."""

    def __init__(self, q, k, v, out, lse, do, *, causal: bool,
                 sm_scale: float, segment_ids=None,
                 window: Optional[int] = None, segment_starts=None,
                 config: FlashConfig):
        _check_inputs(q, k, v, out, lse, do)
        bs, hq, q_len, d = q.shape
        _, hkv, kv_len, _ = k.shape
        self.bf16 = q.dtype == torch.bfloat16
        starts = _starts_key(segment_starts)
        items = (0, 0)
        if self.bf16:
            # the tiles' width (64, 128, 256 or 512 columns, the head dims
            # past d 0 or unread) and the instance's tiles at it
            w = next(t for t in (*FLASH_HEAD_DIMS, WIDE_HEAD_DIM,
                                 WIDER_HEAD_DIM) if d <= t)
            cfg = bwd_config(w)
            self.kv_table, self.q_table = _device_tiles(
                q_len, kv_len, causal, window, starts, cfg.block_m,
                cfg.block_n, str(q.device))
        else:
            t = bwd_f32_config(d).block_m
            self.kv_table, kv_n, self.q_table, q_n = _device_f32_work(
                q_len, kv_len, causal, window, starts, t, bwd_f32_split(d),
                str(q.device))
            items = (kv_n, q_n)
        q, k, v, out, do = (_aligned(t) for t in (q, k, v, out, do))
        lse = _aligned(lse)
        self.grads = (torch.empty_like(q), torch.empty_like(k),
                      torch.empty_like(v))
        q_seg = kv_seg = None
        if segment_ids is not None:
            q_seg = as_int32(segment_ids[0], (bs, q_len), q)
            kv_seg = as_int32(segment_ids[1], (bs, kv_len), q)
        bufs = (None,) * 6
        if self.bf16:
            q_pad = -(-q_len // cfg.block_m) * cfg.block_m
            kv_pad = -(-kv_len // cfg.block_n) * cfg.block_n
            if q_seg is not None:
                q_seg = F.pad(q_seg, (0, q_pad - q_len)).contiguous()
            # dq's f32 sums, then the chain counters of each (batch, q
            # head, q tile, 64-column part), zeroed together; dk and dv in
            # one f32 slot per q head, written by the main kernel: all at
            # the tiles' width (at 512 and (1, 64, 2048): 256 MiB of dq
            # sums and 512 MiB of slots)
            n_dq, n_kv = bs * hq * q_pad * w, bs * hq * kv_pad * w
            n_cnt = bs * hq * (q_pad // cfg.block_m) * (w // 64)
            acc = torch.zeros(n_dq + n_cnt, dtype=torch.float32,
                              device=q.device)
            dkv = torch.empty(2 * n_kv, dtype=torch.float32,
                              device=q.device)
            rows = torch.empty((2, bs * hq * q_pad), dtype=torch.float32,
                               device=q.device)
            bufs = (torch.empty_like(q), rows[0], rows[1], acc[:n_dq],
                    dkv[:n_kv], dkv[n_kv:], acc[n_dq:].view(torch.int32))
            self.turns = bufs[-1]
        else:
            # rowsum(dout * out); one f32 slot of t x d per (work item,
            # q head) for each of dq (q-major items), dk and dv (kv-major),
            # every one written by its block
            delta = (do * out).sum(-1)
            n = bs * hq * t * d
            kv_n, q_n = items
            slots = torch.empty((q_n + 2 * kv_n) * n, dtype=torch.float32,
                                device=q.device)
            self.slots = (slots[:q_n * n], slots[q_n * n:(q_n + kv_n) * n],
                          slots[(q_n + kv_n) * n:])
            bufs = (None, None, delta, *self.slots, None)
            self.turns = None
        self._keep = (q, k, v, out, lse, do, q_seg, kv_seg, bufs)
        ptr = (lambda t: None if t is None else t.data_ptr())
        self._args = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), *(ptr(t) for t in bufs[:3]),
            ptr(q_seg), ptr(kv_seg), self.kv_table.data_ptr(),
            self.q_table.data_ptr(), *(ptr(t) for t in bufs[3:]),
            *(g.data_ptr() for g in self.grads),
            bs, hq, hkv, q_len, kv_len, d, int(causal), window or 0,
            *items, in_dtype(sm_scale * LOG2E, q.dtype), sm_scale,
            _KERNEL_DTYPES[q.dtype], int(config.narrow_products))
        self.device = q.device

    def run(self, stages: int = 7) -> None:
        with _build.on_device(self.device):
            err = _flash_bwd_fn()(*self._args, stages,
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_bwd")


def _flash_bwd_cuda(q, k, v, out, lse, do, **kw):
    """Launches the kernels of csrc/flash_bwd.cu on q, k, v, out and do as
    they are, or padded where the kernels do not read the head_dim in place
    (ops/dims.py::flash_head_dim); returns (dq, dk, dv) at the true
    head_dim."""
    d = q.shape[-1]
    dk = flash_head_dim(d, q.dtype, "the CUDA backward kernels",
                        backward=True)
    q, k, v, out, do = (pad_head_dim(t, dk) for t in (q, k, v, out, do))
    call = BwdLaunch(q, k, v, out, lse, do, **kw)
    call.run()
    flash_attention_bwd.launches += 1
    return tuple(unpad_head_dim(g, d) for g in call.grads)
