"""Flash-attention backward: the public entry, its plain version, its kernels.

Counterpart of the JAX package's five backward entry points, which compute
one contract and differ only in TPU scheduling:
`ops/flash_tri_bwd.py::tri_flash_bwd` and `::tri_flash_bwd_banded`,
`ops/flash_bwd.py::_flash_bwd_fused` and `::flash_attention_bwd` (its split
dq and dk/dv kernels). One Hopper source, csrc/flash_bwd.cu, ports all five:
in bf16 as one pass (a preprocess, the wgmma/TMA main kernel, a
postprocess), in f32 as two kernels (dq, and dk/dv summed over the GQA
group). Both take the masks of JAX's `flash_attention_bwd`: the sliding
window, segment ids and static `segment_starts`. A CPU tensor takes the
plain version; a CUDA tensor takes the kernels or raises for what they do
not do (quantized K/V, head_dim other than 64 or 128). There is no fallback
from the card to the plain version.

Which tiles the kernels visit comes from `bwd_tiles`, a table built on the
host as JAX's work lists are (`_build_bwd_worklist` and its q-major twin):
causal, window and `segment_starts` clamp each tile's range; they prune
work and change no result.

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
    FLASH_BWD_BF16, FLASH_BWD_F32)
from tiny_flash_attention_tpu_torch.ops.flash import (
    LOG2E, _KERNEL_DTYPES, _KERNEL_HEAD_DIMS, _aligned, as_int32, in_dtype,
    visible_mask)
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool,
                        sm_scale: Optional[float] = None, segment_ids=None,
                        window: Optional[int] = None, segment_starts=None):
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
    do = do.to(q.dtype)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                               sm_scale=sm_scale, segment_ids=segment_ids,
                               window=window, segment_starts=segment_starts)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                     sm_scale=sm_scale,
                                     segment_ids=segment_ids, window=window)


# calls that launched the kernels, counted by _flash_bwd_cuda; a bf16 call
# launches flash_bwd_prep, flash_bwd_main and flash_bwd_post once each, an
# f32 call the dq and the dk/dv kernel once each
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


@functools.lru_cache(maxsize=64)
def _device_tiles(q_len, kv_len, causal, window, starts, block_m, block_n,
                  device):
    kv_t, q_t = bwd_tiles(q_len, kv_len, causal=causal, window=window,
                          segment_starts=starts, block_m=block_m,
                          block_n=block_n)
    both = torch.as_tensor(np.concatenate([kv_t, q_t], axis=1),
                           device=device)
    return both[:, :kv_t.shape[1]].contiguous(), \
        both[:, kv_t.shape[1]:].contiguous()


# --- the kernels -------------------------------------------------------------


def _flash_bwd_fn():
    fn = _build.library("flash_bwd").tfa_flash_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d}: the CUDA backward kernels "
                                  f"take {_KERNEL_HEAD_DIMS}")
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
    kernels (bf16: 1 prep, 2 main, 4 post; f32: 1 dq, 2 dk/dv), so that
    chip_smoke.py can time each alone. `grads` are (dq, dk, dv)."""

    def __init__(self, q, k, v, out, lse, do, *, causal: bool,
                 sm_scale: float, segment_ids=None,
                 window: Optional[int] = None, segment_starts=None):
        _check_inputs(q, k, v, out, lse, do)
        bs, hq, q_len, d = q.shape
        _, hkv, kv_len, _ = k.shape
        self.bf16 = q.dtype == torch.bfloat16
        cfg = FLASH_BWD_BF16 if self.bf16 else FLASH_BWD_F32
        self.kv_table, self.q_table = _device_tiles(
            q_len, kv_len, causal, window, _starts_key(segment_starts),
            cfg.block_m, cfg.block_n, str(q.device))
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
            n_dq, n_kv = bs * hq * q_pad * d, bs * hkv * kv_pad * d
            acc = torch.zeros(n_dq + 2 * n_kv, dtype=torch.float32,
                              device=q.device)
            rows = torch.empty((2, bs * hq * q_pad), dtype=torch.float32,
                               device=q.device)
            bufs = (torch.empty_like(q), rows[0], rows[1], acc[:n_dq],
                       acc[n_dq:n_dq + n_kv], acc[n_dq + n_kv:])
        else:
            delta = (do * out).sum(-1)
            bufs = (None, None, delta, None, None, None)
        self._keep = (q, k, v, out, lse, do, q_seg, kv_seg, bufs)
        ptr = (lambda t: None if t is None else t.data_ptr())
        self._args = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), *(ptr(t) for t in bufs[:3]),
            ptr(q_seg), ptr(kv_seg), self.kv_table.data_ptr(),
            self.q_table.data_ptr(), *(ptr(t) for t in bufs[3:]),
            *(g.data_ptr() for g in self.grads),
            bs, hq, hkv, q_len, kv_len, d, int(causal), window or 0,
            in_dtype(sm_scale * LOG2E, q.dtype), sm_scale,
            _KERNEL_DTYPES[q.dtype])
        self.device = q.device

    def run(self, stages: Optional[int] = None) -> None:
        if stages is None:
            stages = 7 if self.bf16 else 3
        with _build.on_device(self.device):
            err = _flash_bwd_fn()(*self._args, stages,
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_bwd")


def _flash_bwd_cuda(q, k, v, out, lse, do, **kw):
    """Launches the kernels of csrc/flash_bwd.cu; returns (dq, dk, dv)."""
    call = BwdLaunch(q, k, v, out, lse, do, **kw)
    call.run()
    flash_attention_bwd.launches += 1
    return call.grads
