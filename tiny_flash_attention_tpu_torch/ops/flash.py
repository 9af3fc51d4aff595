"""Flash-attention forward: the public entry, its plain version, its kernel.

Counterpart of tiny_flash_attention_tpu/ops/flash.py::flash_attention. The
three TPU forward kernels behind it (`_fwd_kernel`, `_tri_kernel`,
`_tri_block_kernel`) compute one contract, so one Hopper kernel,
csrc/flash_fwd.cu, ports all three. A CPU tensor takes the plain version
(`flash_attention_plain`, the port of `_xla_attention`); a CUDA tensor takes
the kernel at every shape, the sliding window, segment ids and
`segment_starts` included, or raises for what the kernel does not do yet
(quantized K/V, head_dim other than 64 or 128). `segment_starts` become the
kernel's tile table (`segment_tiles`): the first kv tile of each q tile, as
JAX's `_build_worklist` prunes its work list to the block diagonal; a window
starts each q tile's kv range at its band, as JAX's work list holds only
band tiles.

The entry is differentiable: `_FlashAttention` is the port of the JAX
custom_vjp (`_flash` and its two rules, flash.py:555-609), window, segment
ids and `segment_starts` included. Its backward is
ops/flash_bwd.py::flash_attention_bwd, the kernels of csrc/flash_bwd.cu on
CUDA and their plain version on the CPU. `return_lse=True` stays off it, as
in JAX: on CUDA a gradient through it raises (`forward_only`).

The JAX entry routes q_len, kv_len <= 512 to XLA; that cutoff was a v5e
measurement, so the port has none until H100 numbers set one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_FWD_BF16, FLASH_FWD_F32)
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KERNEL_HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=64)
def in_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype` (the TPU kernels fold their q scale in the input
    dtype: `q * jnp.asarray(sm_scale * log2e, q.dtype)`). Cached: the
    kernel wrappers call it on every launch with the same few scales."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


@dataclasses.dataclass(frozen=True)
class SegmentTiles:
    """Static `segment_starts` as the forward kernel's tile table, on the
    device: `tile_lo[i]` is the first kv tile q tile i visits (the segment
    start of its first row), `order[i]` the q tile block i takes, longest
    pruned work first; `starts` the offsets themselves, from which the
    backward builds its own table. Built by `segment_tiles`."""
    starts: tuple
    q_len: int
    causal: bool
    block_m: int
    block_n: int
    tile_lo: torch.Tensor
    order: torch.Tensor


def _fwd_tiles(dtype: torch.dtype):
    return FLASH_FWD_BF16 if dtype == torch.bfloat16 else FLASH_FWD_F32


def segment_tiles(segment_starts, q_len: int, *, causal: bool,
                  dtype: torch.dtype, device) -> SegmentTiles:
    """The kernel's tile table for a packed row of q_len (== kv_len) tokens
    whose segments start at `segment_starts` (JAX's `_build_worklist`,
    flash.py:100-128: a q tile's kv range starts at the tile of its first
    row's segment start). One host-to-device copy: build it once and pass
    it to every layer's `flash_attention(..., segment_starts=tiles)`."""
    starts = tuple(sorted({0, *(int(x) for x in segment_starts)}))
    if starts[0] < 0 or starts[-1] >= q_len:
        raise ValueError(f"segment_starts {segment_starts} outside "
                         f"[0, {q_len})")
    cfg = _fwd_tiles(dtype)
    bm, bn = cfg.block_m, cfg.block_n
    n_kv = -(-q_len // bn)
    first = np.arange(-(-q_len // bm)) * bm
    if causal:
        hi = np.minimum(n_kv, (np.minimum(first + bm, q_len) - 1) // bn + 1)
    else:
        hi = np.full(first.shape, n_kv)
    table = np.asarray(starts)
    seg_start = table[np.searchsorted(table, first, side="right") - 1]
    lo = np.minimum(seg_start // bn, hi - 1)
    order = np.argsort(lo - hi, kind="stable")
    both = torch.as_tensor(np.stack([lo, order]).astype(np.int32),
                           device=device)
    return SegmentTiles(starts, q_len, causal, bm, bn, both[0], both[1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    segment_ids=None, window: Optional[int] = None,
                    segment_starts=None, return_lse: bool = False):
    """Flash-attention-2 forward.

    Args:
      q: (batch, q_heads, q_len, head_dim)
      k, v: (batch, kv_heads, kv_len, head_dim); q_heads % kv_heads == 0
      causal: row i sits at position i + kv_len - q_len (decode offset)
      sm_scale: softmax scale, default 1/sqrt(head_dim)
      segment_ids: optional (q_seg (b, q_len), kv_seg (b, kv_len)) int pair;
        only tokens with equal ids attend each other
      window: optional sliding window (requires causal): row at position p
        sees columns [p - window + 1, p]
      segment_starts: static segment offsets (q_len == kv_len), or the
        `SegmentTiles` built from them once for many calls; on CUDA they
        prune each q tile's kv range to its segment (JAX prunes its work
        list), on the CPU they change nothing (the ids carry the mask)
      return_lse: also return the natural-log LSE (batch, q_heads, q_len) f32

    Returns out (like q), and lse if asked. fp16 computes in f32, as in
    the JAX package, and its gradient flows through the casts. Gradients
    flow through `_FlashAttention` (the kernels on CUDA, their plain
    versions on the CPU), with the window, segment ids and segment_starts.
    return_lse=True is forward-only, as in JAX (flash.py:704-707): on the
    CPU it takes the plain forward, on CUDA a backward through it raises.
    """
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA needs q_heads {hq} % kv_heads {hkv} == 0")
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        window = int(window)
    if segment_starts is not None:
        if segment_ids is None:
            raise ValueError("segment_starts prunes scheduling; "
                             "segment_ids carry the mask")
        if q_len != kv_len:
            raise ValueError("segment_starts requires q_len == kv_len")
    if q.dtype == torch.float16:
        out = flash_attention(
            q.float(), k.float(), v.float(), causal=causal,
            sm_scale=sm_scale, segment_ids=segment_ids, window=window,
            segment_starts=segment_starts, return_lse=return_lse)
        if return_lse:
            return out[0].to(torch.float16), out[1]
        return out.to(torch.float16)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    if return_lse and not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale,
                                     segment_ids=segment_ids, window=window,
                                     return_lse=True)
    masks = {} if window is None else {"window": window}
    if segment_ids is not None:
        masks.update(q_seg=as_int32(segment_ids[0], (bs, q_len), q),
                     kv_seg=as_int32(segment_ids[1], (bs, kv_len), q))
        if segment_starts is not None and q.is_cuda:
            masks["tiles"] = _tiles_for(segment_starts, q_len, causal, q)
    if return_lse:
        return forward_only(
            "flash_attention(return_lse=True)",
            lambda: _flash_fwd_cuda(q, k, v, causal=causal,
                                    sm_scale=sm_scale, **masks), q, k, v)
    return _FlashAttention.apply(q, k, v, causal, sm_scale, masks)


# kernel launches, counted by _flash_fwd_cuda; window_launches those with a
# sliding window
flash_attention.launches = 0
flash_attention.window_launches = 0


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v), saving (q, k, v, out, lse) and the masks
    (window, ids, the static segment starts) for a backward that
    recomputes p tile by tile. The forward is the kernel on CUDA and the
    plain version on the CPU; so is the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, masks: dict):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        window = masks.get("window")
        segment_ids = None
        if "q_seg" in masks:
            segment_ids = (masks["q_seg"], masks["kv_seg"])
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, causal=causal,
                                       sm_scale=sm_scale, **masks)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             sm_scale=sm_scale,
                                             segment_ids=segment_ids,
                                             window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.window, ctx.segment_ids = window, segment_ids
        tiles = masks.get("tiles")
        ctx.segment_starts = None if tiles is None else tiles.starts
        return out

    @staticmethod
    def backward(ctx, do):
        # imported here: ops/flash_bwd.py imports this module's helpers
        from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
            flash_attention_bwd)
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do, causal=ctx.causal, sm_scale=ctx.sm_scale,
            segment_ids=ctx.segment_ids, window=ctx.window,
            segment_starts=ctx.segment_starts)
        return dq, dk, dv, None, None, None


def flash_attention_plain(q, k, v, *, causal: bool, sm_scale: float,
                          segment_ids=None, window: Optional[int] = None,
                          return_lse: bool = False):
    """Plain PyTorch forward with the kernel's semantics (the port of
    `_xla_attention`, flash.py:712-754): GQA, decode-offset causal mask,
    window, segments, the empty-row guard and the `m * ln2` LSE sentinel of
    fully-masked rows. Runs on any device; materializes the scores."""
    bs, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    guard = (causal and kv_len < q_len) or segment_ids is not None
    valid = visible_mask(q_len, kv_len, q.device, causal=causal,
                         window=window, segment_ids=segment_ids)
    if valid is not None:
        s = torch.where(valid, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if guard:
        p = p * (m > 0.5 * DEFAULT_MASK_VALUE)   # fully-masked rows -> 0
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul((p / l_safe).to(v.dtype).float(), v.float()).to(
        q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l_safe))[..., 0]
    if guard:
        # fully-masked rows carry the kernel's log2-domain sentinel m * ln2
        lse = torch.where(m[..., 0] > 0.5 * DEFAULT_MASK_VALUE, lse,
                          m[..., 0] * LN2)
    return out, lse


def visible_mask(q_len: int, kv_len: int, device, *, causal: bool,
                 window: Optional[int] = None, segment_ids=None):
    """Which (row, column) pairs attend, as a bool tensor that broadcasts
    over (batch, heads, q_len, kv_len), or None when all do: causal with
    the decode offset (row i sits at i + kv_len - q_len), the window (the
    row at position p sees [p - window + 1, p]) and equal segment ids."""
    valid = None
    if causal:
        pos = torch.arange(q_len, device=device)[:, None] + kv_len - q_len
        cols = torch.arange(kv_len, device=device)[None, :]
        valid = cols <= pos
        if window is not None:
            valid &= cols >= pos - window + 1
    if segment_ids is not None:
        qseg, kvseg = (torch.as_tensor(x, device=device)
                       for x in segment_ids)
        seg_ok = qseg[:, None, :, None] == kvseg[:, None, None, :]
        valid = seg_ok if valid is None else valid & seg_ok
    return valid


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def as_int32(x, shape, like: torch.Tensor) -> torch.Tensor:
    """An int32 operand of the kernel (segment ids, lengths) on q's device,
    contiguous; already there, it is not copied."""
    t = torch.as_tensor(x, device=like.device).to(torch.int32).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def _tiles_for(segment_starts, q_len: int, causal: bool,
               q: torch.Tensor) -> SegmentTiles:
    """`segment_starts` as a tile table that fits this launch, built here
    when the caller passed the static offsets."""
    if not isinstance(segment_starts, SegmentTiles):
        return segment_tiles(segment_starts, q_len, causal=causal,
                             dtype=q.dtype, device=q.device)
    cfg = _fwd_tiles(q.dtype)
    if (segment_starts.q_len, segment_starts.causal, segment_starts.block_m,
            segment_starts.block_n, segment_starts.tile_lo.device) != (
            q_len, causal, cfg.block_m, cfg.block_n, q.device):
        raise ValueError("SegmentTiles were built for another q_len, mask, "
                         "tile size or device")
    return segment_starts


def _flash_fwd_fn():
    fn = _build.library("flash_fwd").tfa_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flash_fwd_cuda(q, k, v, *, causal: bool, sm_scale: float, **masks):
    """Launches csrc/flash_fwd.cu for `flash_attention`; returns (out,
    lse)."""
    out = launch_fwd(q, k, v, causal=causal, sm_scale=sm_scale, **masks)
    flash_attention.launches += 1
    if masks.get("window") is not None:
        flash_attention.window_launches += 1
    return out


def launch_fwd(q, k, v, *, causal: bool, sm_scale: float, q_seg=None,
               kv_seg=None, tiles: Optional[SegmentTiles] = None,
               seq_lengths=None, window: Optional[int] = None):
    """One launch of csrc/flash_fwd.cu, counted by the caller; returns (out,
    lse). q_seg/kv_seg, tiles and seq_lengths (int32 on q's device) turn on
    the kernel's segment mask, its pruned kv ranges and its jagged mode;
    window (causal, no seq_lengths) its sliding window."""
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, _ = k.shape
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise NotImplementedError(
            f"the CUDA forward kernel takes bf16 or f32 q/k/v of one dtype "
            f"(quantized K/V are not ported yet), got {q.dtype}, {k.dtype}, "
            f"{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d}: the CUDA forward kernel "
                                  f"takes {_KERNEL_HEAD_DIMS}")
    if not (k.is_cuda and v.is_cuda and k.device == q.device
            and v.device == q.device):
        raise ValueError("q, k and v must be on one CUDA device")
    if k.shape != (bs, hkv, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"shapes {q.shape}, {k.shape}, {v.shape}")
    if q_len == 0 or kv_len == 0 or bs == 0:
        raise ValueError("empty q or kv")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((bs, hq, q_len), dtype=torch.float32, device=q.device)
    scale_log2 = in_dtype(sm_scale * LOG2E, q.dtype)
    extras = (q_seg, kv_seg, None if tiles is None else tiles.tile_lo,
              None if tiles is None else tiles.order, seq_lengths)
    with _build.on_device(q.device):
        err = _flash_fwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *(None if t is None else t.data_ptr()
                              for t in extras),
            bs, hq, hkv, q_len, kv_len, d, int(causal), window or 0,
            scale_log2,
            _KERNEL_DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_fwd")
    return out, lse
