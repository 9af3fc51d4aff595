"""Flash-attention forward: the public entry, its plain version, its kernel.

Counterpart of tiny_flash_attention_tpu/ops/flash.py::flash_attention. The
three TPU forward kernels behind it (`_fwd_kernel`, `_tri_kernel`,
`_tri_block_kernel`) compute one contract, so one Hopper kernel,
csrc/flash_fwd.cu, ports all three (bf16: wgmma and TMA over 128-row tiles,
64-row kv tiles at the wide instance, head dims above 128, and 64-row q and
32-row kv tiles at the instance of width 512, head dims above 256; f32: the
CUDA cores over 128-row q and 64-row kv tiles, 64 and 32 at the wide
instance). A CPU tensor takes the plain version (`flash_attention_plain`,
the port of `_xla_attention`); a CUDA tensor takes the kernel at every
shape, the sliding window, segment ids and `segment_starts` included, or
raises for what the kernel does not do yet (head_dim above 512 in bf16 over
bf16 K/V, above 256 in f32 or over quantized K/V). The bf16 kernel over
bf16 K/V reads and writes any head_dim that is a multiple of 8 up to 512 at
its true width (the zero columns of JAX's padding to 128 lanes, which add
exact zeros, are TMA's fill past column d); every other head_dim, and
every head_dim of the f32 instances and the quantized ones (tiles of 64,
128 and 256 columns), is padded with zero columns to the next tile width
(512 above 256 in bf16) and the output sliced back
(ops/dims.py::flash_head_dim). The autograd Function saves the tensors it
handed the kernel (padded only where the forward padded), so the backward
runs on them and returns gradients at the true head_dim. The f32 instance
walks a work list (`fwd_f32_work`): each q tile's kv range cut into runs,
one block each, merged in run order in the kernel (`f32_split_merge_plain`
is that layout and order in plain PyTorch). Quantized K/V take the
quantized instances of the kernel, csrc/flash_fwd_quant.cu (bf16 q: the
same wgmma/TMA kernel over 128-row tiles, 64-row kv tiles at 256, its
producer converting the payloads), through
ops/flash_quant.py::flash_attention_quantized. `segment_starts` become the
kernel's tile table (`segment_tiles`): the first kv tile of each q tile, as
JAX's `_build_worklist` prunes its work list to the block diagonal, built
for each instance's own tiles on first use; a window starts each q tile's kv
range at its band, as JAX's work list holds only band tiles.

The entry is differentiable: `_FlashAttention` is the port of the JAX
custom_vjp (`_flash` and its two rules, flash.py:555-609), window, segment
ids and `segment_starts` included (on CUDA in bf16 up to head_dim 512, in
f32 up to 256: above, its backward() raises, naming the ROADMAP queue).
Its backward is ops/flash_bwd.py::flash_attention_bwd, the kernels of
csrc/flash_bwd.cu on CUDA and their plain version on the CPU. `return_lse=True` stays off it, as
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
from tiny_flash_attention_tpu_torch.ops import configs
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_FWD_BF16, FLASH_FWD_BF16_512, FLASH_FWD_BF16_WIDE, FLASH_FWD_F32,
    FLASH_FWD_F32_WIDE, FlashConfig, TileConfig, fwd_smem_bytes,
    resolve_config)
from tiny_flash_attention_tpu_torch.ops.dims import (
    FLASH_HEAD_DIMS, WIDE_HEAD_DIM, WIDER_HEAD_DIM, flash_head_dim,
    pad_head_dim, unpad_head_dim)
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# K/V payload formats of the quantized instances (csrc/flash_fwd_quant.cu)
PAYLOAD_FORMATS = {torch.int8: 1, torch.float8_e4m3fn: 2}


@functools.lru_cache(maxsize=64)
def in_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype` (the TPU kernels fold their q scale in the input
    dtype: `q * jnp.asarray(sm_scale * log2e, q.dtype)`). Cached: the
    kernel wrappers call it on every launch with the same few scales."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentTiles:
    """Static `segment_starts` of a packed row of q_len (== kv_len) tokens,
    as the forward kernels' tile tables on `device`: `table(cfg)` gives, for
    the q and kv tiles of one forward instance, `tile_lo[i]` (the first kv
    tile q tile i visits, the segment start of its first row) and
    `order[i]` (the q tile block i takes, longest pruned work first). Each
    table is built on first use and kept, one per tile config, so one
    object serves every layer and both the bf16 and the quantized entries.
    `starts` are the offsets themselves, from which the backward builds
    its own table. Built by `segment_tiles`."""
    starts: tuple
    q_len: int
    causal: bool
    device: torch.device
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    def table(self, cfg: TileConfig) -> tuple[torch.Tensor, torch.Tensor]:
        """(tile_lo, order) int32 on the device for `cfg`'s tiles."""
        key = (cfg.block_m, cfg.block_n)
        if key not in self._tables:
            lo, _, order = tile_table(self.starts, self.q_len,
                                      causal=self.causal,
                                      block_m=cfg.block_m,
                                      block_n=cfg.block_n)
            both = torch.as_tensor(np.stack([lo, order]).astype(np.int32),
                                   device=self.device)
            self._tables[key] = (both[0], both[1])
        return self._tables[key]


def fwd_config(dtype: torch.dtype, quantized: bool = False,
               head_dim: int = 128) -> TileConfig:
    """The tiles of the forward instance for q's dtype over unquantized or
    quantized (int8/e4m3) K/V at head_dim (each q dtype's design takes
    both; `quantized` changes no tile): above 128, the wide instance's
    (bf16: 64-row kv tiles; f32: 64-row q and 32-row kv tiles); above 256,
    bf16's instance of width 512 (64-row q and 32-row kv tiles)."""
    wide = head_dim > FLASH_HEAD_DIMS[-1]
    if dtype != torch.bfloat16:
        return FLASH_FWD_F32_WIDE if wide else FLASH_FWD_F32
    if head_dim > WIDE_HEAD_DIM:
        return FLASH_FWD_BF16_512
    return FLASH_FWD_BF16_WIDE if wide else FLASH_FWD_BF16


def tile_table(starts, q_len: int, *, causal: bool, block_m: int,
               block_n: int):
    """The kv range [lo, hi) of each q tile of a packed row (JAX's
    `_build_worklist`, flash.py:100-128: a q tile's range starts at the
    tile of its first row's segment start; causal, it ends at the tile of
    its last row, as the kernels' `kv_tiles` clamps it) and the order of
    the q tiles, longest range first. numpy int arrays (lo, hi, order)."""
    bm, bn = block_m, block_n
    n_kv = -(-q_len // bn)
    first = np.arange(-(-q_len // bm)) * bm
    if causal:
        hi = np.minimum(n_kv, (np.minimum(first + bm, q_len) - 1) // bn + 1)
    else:
        hi = np.full(first.shape, n_kv)
    table = np.asarray(sorted(starts))
    seg_start = table[np.searchsorted(table, first, side="right") - 1]
    lo = np.minimum(seg_start // bn, hi - 1)
    order = np.argsort(lo - hi, kind="stable")
    return lo, hi, order


def segment_tiles(segment_starts, q_len: int, *, causal: bool,
                  device) -> SegmentTiles:
    """The kernels' tile tables for a packed row of q_len (== kv_len)
    tokens whose segments start at `segment_starts`. Build it once and pass
    it to every layer's `flash_attention(..., segment_starts=tiles)` (or
    `flash_attention_quantized`'s): each instance's table is copied to the
    device once, at its first launch."""
    starts = tuple(sorted({0, *(int(x) for x in segment_starts)}))
    if starts[0] < 0 or starts[-1] >= q_len:
        raise ValueError(f"segment_starts {segment_starts} outside "
                         f"[0, {q_len})")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return SegmentTiles(starts, q_len, causal, device)


def run_work(table, split: int):
    """A work list from a (3, n) tile table (lo, hi, order: `fwd_f32_tiles`,
    ops/flash_bwd.py::bwd_tiles): each tile's range [lo, hi) of the other
    side's tiles cut at the multiples of `split` into runs of at most
    `split`, one item each, in range order (a tile with an empty range is
    one empty item, whose block writes zeros). The cuts sit at fixed
    tiles, so a range that `segment_starts` prunes keeps the unpruned
    range's runs from its first tile on (the pruned tiles and runs add
    exact zeros): the pruning changes no bit. Returns (flat int32 array:
    tile[m], lo[m], hi[m], order[m] (the items longest run first, the
    order in which blocks take them), first[n + 1] (tile t's items are
    first[t] .. first[t + 1] - 1); m, the number of items)."""
    lo, hi = (np.asarray(r, np.int64) for r in table[:2])
    items, first = [], [0]
    for t in range(lo.size):
        if hi[t] <= lo[t]:
            items.append((t, 0, 0))
        for a in range(int(lo[t]) - int(lo[t]) % split, int(hi[t]), split):
            items.append((t, max(int(lo[t]), a), min(int(hi[t]), a + split)))
        first.append(len(items))
    tile, ilo, ihi = (np.asarray(c, np.int64) for c in zip(*items))
    order = np.argsort(-(ihi - ilo), kind="stable")
    flat = np.concatenate([tile, ilo, ihi, order, first]).astype(np.int32)
    return flat, len(items)


def fwd_f32_tiles(q_len: int, kv_len: int, *, causal: bool,
                  window: Optional[int] = None, starts=None,
                  cfg: TileConfig = FLASH_FWD_F32):
    """The f32 forward's tile table, (3, n) int64 (lo, hi, order): the kv
    tiles [lo, hi) of each q tile of `cfg` (FLASH_FWD_F32, or
    FLASH_FWD_F32_WIDE above head_dim 128), clamped as the kernels clamp
    them: causal up to the tile of its last row's position (the
    decode offset; at least one tile, so rows before every column get the
    sentinel), from the tile of its first row's segment start
    (`segment_starts`, as `tile_table`) and of its first row's window
    edge; order, the tiles longest range first."""
    bm, bn = cfg.block_m, cfg.block_n
    n_kv = -(-kv_len // bn)
    first = np.arange(-(-q_len // bm), dtype=np.int64) * bm
    offset = kv_len - q_len
    hi = np.full(first.shape, n_kv)
    if causal:
        last = np.minimum(first + bm, q_len) - 1 + offset
        hi = np.where(last < 0, 1, np.minimum(n_kv, np.maximum(last, 0)
                                              // bn + 1))
    lo = np.zeros_like(first)
    if starts is not None:
        table = np.asarray(sorted({0, *(int(x) for x in starts)}))
        seg_start = table[np.searchsorted(table, first, side="right") - 1]
        lo = np.minimum(seg_start // bn, hi - 1)
    if window is not None:
        left = first + offset - window + 1
        lo = np.where(left > 0, np.maximum(lo, np.minimum(
            np.maximum(left, 0) // bn, hi - 1)), lo)
    order = np.argsort(lo - hi, kind="stable")
    return np.stack([lo, hi, order])


def fwd_f32_split(q_len: int, kv_len: int, *, causal: bool,
                  n_bh: int, config: FlashConfig,
                  cfg: TileConfig = FLASH_FWD_F32) -> int:
    """The f32 forward's run length in `cfg`'s kv tiles for a launch of
    n_bh = batch x q heads, from the shape alone (so `segment_starts` and
    the window change no cut): every kv tile, one run a q tile, where the q
    tiles give at least ops/configs.py::FLASH_FWD_F32_SPLIT_BELOW blocks;
    else the least S from the columns of `config.f32_split` tiles of
    FLASH_FWD_F32 up whose runs of the q tiles that split take at most
    FLASH_FWD_F32_MAX_SLOTS partial slots over the n_bh rows (counted on
    the unpruned causal ranges, which a window or segment_starts only
    shorten; both bounds read at each call)."""
    lo, hi = fwd_f32_tiles(q_len, kv_len, causal=causal, cfg=cfg)[:2]
    n_kv = -(-kv_len // cfg.block_n)
    first = config.f32_split * FLASH_FWD_F32.block_n // cfg.block_n
    if lo.size * n_bh >= configs.FLASH_FWD_F32_SPLIT_BELOW or first >= n_kv:
        return max(first, n_kv)   # one run a q tile
    s = np.arange(first, n_kv + 1)[:, None]
    runs = -(-hi // s) - lo // s
    slots = np.where(runs > 1, runs, 0).sum(axis=1) * n_bh
    return int(s[np.argmax(slots <= configs.FLASH_FWD_F32_MAX_SLOTS), 0])


def fwd_f32_work(q_len: int, kv_len: int, *, causal: bool,
                 window: Optional[int] = None, starts=None,
                 split: Optional[int] = None, n_bh: int = 1,
                 cfg: TileConfig = FLASH_FWD_F32,
                 config: FlashConfig = FlashConfig()):
    """The f32 forward's work list at `cfg`'s tiles: `run_work` of
    `fwd_f32_tiles` at runs of `split` kv tiles (default `fwd_f32_split`
    for n_bh = batch x q heads under `config`)."""
    if split is None:
        split = fwd_f32_split(q_len, kv_len, causal=causal, n_bh=n_bh,
                              config=config, cfg=cfg)
    return run_work(fwd_f32_tiles(q_len, kv_len, causal=causal,
                                  window=window, starts=starts, cfg=cfg),
                    split)


def fwd_f32_slots(flat, m: int):
    """The merge slot of each item of an f32 work list (`fwd_f32_work`):
    the items of q tiles of more than one run numbered in item order, -1
    for a tile of one run, which writes its rows directly. Returns (int32
    array of m slots, the number of slots)."""
    runs = np.diff(flat[4 * m:])
    split = np.repeat(runs > 1, runs)
    return (np.where(split, np.cumsum(split) - 1, -1).astype(np.int32),
            int(split.sum()))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    segment_ids=None, window: Optional[int] = None,
                    segment_starts=None,
                    config: Optional[FlashConfig] = None,
                    return_lse: bool = False):
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
      config: the kernels' run-time choices (ops/configs.py::FlashConfig,
        default FlashConfig()), checked before any launch; the backward
        takes the same. On the CPU it changes nothing.
      return_lse: also return the natural-log LSE (batch, q_heads, q_len) f32

    Returns out (like q), and lse if asked. fp16 computes in f32, as in
    the JAX package, and its gradient flows through the casts. Gradients
    flow through `_FlashAttention` (the kernels on CUDA, their plain
    versions on the CPU), with the window, segment ids and segment_starts.
    return_lse=True is forward-only, as in JAX (flash.py:704-707): on the
    CPU it takes the plain forward, on CUDA a backward through it raises.
    """
    _, hq, q_len, d = q.shape
    _, hkv, kv_len, _ = k.shape
    window = check_masks(hq, hkv, q_len, kv_len, causal=causal,
                         window=window, segment_ids=segment_ids,
                         segment_starts=segment_starts)
    config = resolve_config(config)
    if q.dtype == torch.float16:
        out = flash_attention(
            q.float(), k.float(), v.float(), causal=causal,
            sm_scale=sm_scale, segment_ids=segment_ids, window=window,
            segment_starts=segment_starts, config=config,
            return_lse=return_lse)
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
    masks = kernel_masks(q, kv_len, causal=causal, window=window,
                         segment_ids=segment_ids,
                         segment_starts=segment_starts)
    if return_lse:
        return forward_only(
            "flash_attention(return_lse=True)",
            lambda: _flash_fwd_cuda(q, k, v, causal=causal,
                                    sm_scale=sm_scale, config=config,
                                    **masks), q, k, v)
    return _FlashAttention.apply(q, k, v, causal, sm_scale, masks, config)


def check_masks(hq: int, hkv: int, q_len: int, kv_len: int, *,
                causal: bool, window, segment_ids, segment_starts):
    """Raises ValueError where JAX's entries assert (GQA, a window without
    causal, segment_starts without ids or with q_len != kv_len); returns
    the window as an int (or None)."""
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
    return window


def kernel_masks(q: torch.Tensor, kv_len: int, *, causal: bool, window,
                 segment_ids, segment_starts) -> dict:
    """The mask operands of one forward launch (`launch_fwd`'s keywords):
    the window, the ids as int32 on q's device and, on CUDA, the tile table
    of `segment_starts`."""
    bs, _, q_len, _ = q.shape
    masks = {} if window is None else {"window": window}
    if segment_ids is not None:
        masks.update(q_seg=as_int32(segment_ids[0], (bs, q_len), q),
                     kv_seg=as_int32(segment_ids[1], (bs, kv_len), q))
        if segment_starts is not None and q.is_cuda:
            masks["tiles"] = _tiles_for(segment_starts, q_len, causal, q)
    return masks


# kernel launches, counted by _flash_fwd_cuda; window_launches those with a
# sliding window
flash_attention.launches = 0
flash_attention.window_launches = 0


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v), saving (q, k, v, out, lse), the masks
    (window, ids, the static segment starts) and the config for a backward
    that recomputes p tile by tile. The forward is the kernel on CUDA and
    the plain version on the CPU; so is the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, masks: dict,
                config: FlashConfig):
        ctx.d = q.shape[-1]
        if q.is_cuda:
            # pad once where the kernels do not read the head_dim in place;
            # the backward runs on the saved tensors
            dk = flash_head_dim(ctx.d, q.dtype, "the CUDA forward kernel")
            q, k, v = (pad_head_dim(t, dk) for t in (q, k, v))
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        window = masks.get("window")
        segment_ids = None
        if "q_seg" in masks:
            segment_ids = (masks["q_seg"], masks["kv_seg"])
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, causal=causal,
                                       sm_scale=sm_scale, config=config,
                                       **masks)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             sm_scale=sm_scale,
                                             segment_ids=segment_ids,
                                             window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.config = causal, sm_scale, config
        ctx.window, ctx.segment_ids = window, segment_ids
        tiles = masks.get("tiles")
        ctx.segment_starts = None if tiles is None else tiles.starts
        return unpad_head_dim(out, ctx.d)

    @staticmethod
    def backward(ctx, do):
        # imported here: ops/flash_bwd.py imports this module's helpers
        from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
            flash_attention_bwd)
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, pad_head_dim(do, q.shape[-1]),
            causal=ctx.causal, sm_scale=ctx.sm_scale,
            segment_ids=ctx.segment_ids, window=ctx.window,
            segment_starts=ctx.segment_starts, config=ctx.config)
        return (*(unpad_head_dim(g, ctx.d) for g in (dq, dk, dv)), None,
                None, None, None)


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


def f32_split_merge_plain(q, k, v, *, causal: bool, sm_scale: float,
                          segment_ids=None, window: Optional[int] = None,
                          segment_starts=None,
                          config: FlashConfig = FlashConfig()):
    """The f32 kernel's run layout and merge order in plain PyTorch: each
    run of `fwd_f32_work` (the tiles of the instance at q's head_dim,
    `fwd_config`; `segment_starts` pruning the ranges) computes its
    partial from its q tile's rows over its kv tiles' columns, q folded by
    scale_log2 as the kernel folds it: m, the
    run's row max in the log2 domain; l, the sum of p = 2^(s - m) (0 on a
    row the run does not see); o = p v. A tile's runs combine in run order:
    o = sum w o_x / sum w l_x, w = 2^(m_x - max m), LSE = max m ln 2 +
    log(sum w l_x), an empty row 0 with the sentinel. Returns (out, lse)
    in f32. A pair outside every run would be lost and one in two counted
    twice, so this holds the work list (under `config`'s runs) to the
    plain forward."""
    bs, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    group = hq // hkv
    cfg = fwd_config(torch.float32, head_dim=d)
    bm, bn = cfg.block_m, cfg.block_n
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    qs = q.float() * in_dtype(sm_scale * LOG2E, torch.float32)
    s2 = torch.matmul(qs, kr.transpose(-1, -2))
    valid = visible_mask(q_len, kv_len, q.device, causal=causal,
                         window=window, segment_ids=segment_ids)
    if valid is not None:
        s2 = torch.where(valid, s2, DEFAULT_MASK_VALUE)
    starts = segment_starts
    if isinstance(starts, SegmentTiles):
        starts = starts.starts
    flat, m = fwd_f32_work(q_len, kv_len, causal=causal, window=window,
                           starts=starts, n_bh=bs * hq, cfg=cfg,
                           config=config)
    _, ilo, ihi, _ = flat[:4 * m].reshape(4, m)
    first = flat[4 * m:]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for t in range(first.size - 1):
        rows = slice(t * bm, min((t + 1) * bm, q_len))
        parts = []
        for it in range(first[t], first[t + 1]):
            cols = slice(int(ilo[it]) * bn, min(int(ihi[it]) * bn, kv_len))
            sr = s2[:, :, rows, cols]
            mr = sr.amax(-1, keepdim=True)
            p = torch.exp2(sr - mr) * (mr > 0.5 * DEFAULT_MASK_VALUE)
            parts.append((mr, p.sum(-1, keepdim=True),
                          torch.matmul(p, vr[:, :, cols])))
        mx = parts[0][0]
        for mr, _, _ in parts[1:]:
            mx = torch.maximum(mx, mr)
        num, den = 0.0, 0.0
        for mr, lr, orr in parts:
            w = torch.where(mr == -math.inf, 0.0, torch.exp2(mr - mx))
            den = den + lr * w
            num = num + orr * w
        l_safe = torch.where(den == 0.0, 1.0, den)
        out[:, :, rows] = num / l_safe
        lse[:, :, rows] = (torch.clamp(mx, min=DEFAULT_MASK_VALUE) * LN2
                           + torch.log(l_safe))[..., 0]
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


def _scale_rows(s: torch.Tensor) -> torch.Tensor:
    """(b, hkv, kv_len, 1) per-token scales as the quantized kernel reads
    them: (b, hkv, ld) rows, ld = kv_len rounded up to whole kv tiles of
    FLASH_FWD_BF16 (128 rows, two of the wide instance's: the kernel reads
    a tile's columns without a bound), padded with zeros where kv_len is
    not, 16-byte aligned."""
    s = s.reshape(s.shape[0], s.shape[1], s.shape[2])
    pad = -s.shape[-1] % FLASH_FWD_BF16.block_n
    if pad:
        s = torch.nn.functional.pad(s, (0, pad))
    return _aligned(s)


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
    """`segment_starts` as the tile tables of this launch, built here when
    the caller passed the static offsets."""
    if not isinstance(segment_starts, SegmentTiles):
        return segment_tiles(segment_starts, q_len, causal=causal,
                             device=q.device)
    if (segment_starts.q_len, segment_starts.causal,
            segment_starts.device) != (q_len, causal, q.device):
        raise ValueError("SegmentTiles were built for another q_len, mask "
                         "or device")
    return segment_starts


def check_smem_layouts(lib: ctypes.CDLL, quantized: bool) -> None:
    """Holds `fwd_smem_bytes` to the shared memory the library's instances
    take (`tfa_flash_fwd_smem` / `tfa_flash_fwd_quant_smem`, from the
    kernels' own layouts) for both dtypes and every tile width, the wide
    one included, and bf16's over bf16 K/V at 512; raises where they
    differ."""
    smem = (lib.tfa_flash_fwd_quant_smem if quantized
            else lib.tfa_flash_fwd_smem)
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    for dtype, code in _KERNEL_DTYPES.items():
        wider = (WIDER_HEAD_DIM,) if dtype == torch.bfloat16 \
            and not quantized else ()
        for d in (*FLASH_HEAD_DIMS, WIDE_HEAD_DIM, *wider):
            cfg = fwd_config(dtype, quantized, d)
            want = fwd_smem_bytes(cfg, d, quantized)
            if smem(code, d) != want:
                raise RuntimeError(
                    f"ops/configs.py::fwd_smem_bytes gives {want} bytes for "
                    f"{cfg} at head_dim {d} (quantized={quantized}); the "
                    f"kernel takes {smem(code, d)}")


def _flash_fwd_fn():
    lib = _build.library("flash_fwd")
    fn = lib.tfa_flash_fwd
    if fn.argtypes is None:
        check_smem_layouts(lib, quantized=False)
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flash_fwd_quant_fn():
    lib = _build.library("flash_fwd_quant")
    fn = lib.tfa_flash_fwd_quant
    if fn.argtypes is None:
        check_smem_layouts(lib, quantized=True)
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _device_fwd_work(q_len, kv_len, causal, window, starts, n_bh, cfg,
                     config, bounds, device):
    """The f32 forward's work list at `cfg`'s tiles for n_bh = batch x q
    heads under `config`'s runs on the device, each item's merge slot
    appended (`fwd_f32_slots`): (list, its items, its slots). `bounds`,
    ops/configs.py's FLASH_FWD_F32_SPLIT_BELOW and _MAX_SLOTS read by the
    caller, keys the cache."""
    flat, m = fwd_f32_work(q_len, kv_len, causal=causal, window=window,
                           starts=starts, n_bh=n_bh, cfg=cfg, config=config)
    slots, n_slots = fwd_f32_slots(flat, m)
    return (torch.as_tensor(np.concatenate([flat, slots]), device=device),
            m, n_slots)


_fwd_workspaces: dict = {}


def fwd_workspace(device, stream: int, n_slots: int, n_bh: int,
                  n_tiles: int, d: int,
                  block_m: int = FLASH_FWD_F32.block_m):
    """(partials f32, arrival counters int32 zeros) of the f32 forward's
    merge: n_slots x n_bh slots of block_m x (d + 2) floats (the q tiles'
    rows: 128, 64 at head_dim 256), one counter per (q tile, q head,
    batch). One workspace per device and stream, grown to the largest
    launch and kept (at most FLASH_FWD_F32_MAX_SLOTS slots,
    `fwd_f32_split`; under 70 MB at either width): the kernel leaves the
    counters at zero, so a call allocates nothing. Launches on one stream
    run in order, so they share it; another stream gets its own. `stream`
    is the launch's CUDA stream handle."""
    key = (str(device), stream)
    need = n_slots * n_bh * block_m * (d + 2), n_bh * n_tiles
    ws = _fwd_workspaces.get(key)
    if ws is None or ws[0].numel() < need[0] or ws[1].numel() < need[1]:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(need[0], have[0]), dtype=torch.float32,
                          device=device),
              torch.zeros(max(need[1], have[1]), dtype=torch.int32,
                          device=device))
        _fwd_workspaces[key] = ws
    return ws


def _flash_fwd_cuda(q, k, v, *, causal: bool, sm_scale: float,
                    config: FlashConfig, **masks):
    """Launches csrc/flash_fwd.cu for `flash_attention`; returns (out,
    lse)."""
    out = launch_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                     config=config, **masks)
    flash_attention.launches += 1
    if masks.get("window") is not None:
        flash_attention.window_launches += 1
    return out


def launch_fwd(q, k, v, *, causal: bool, sm_scale: float, q_seg=None,
               kv_seg=None, tiles: Optional[SegmentTiles] = None,
               seq_lengths=None, window: Optional[int] = None,
               k_scales=None, v_scales=None, config: FlashConfig):
    """One launch of csrc/flash_fwd.cu, counted by the caller; returns (out,
    lse). `config`, checked by the entry, picks the narrow bf16 instances
    and the f32 instance's kv runs. q_seg/kv_seg, tiles and seq_lengths
    (int32 on q's device) turn on
    the kernel's segment mask, its pruned kv ranges and its jagged mode;
    window (causal, no seq_lengths) its sliding window. With k_scales and
    v_scales ((b, hkv, kv_len, 1) f32), k and v are int8 or e4m3 payloads
    of one format and the quantized instances (csrc/flash_fwd_quant.cu)
    run, every mask but the jagged mode included. bf16 over bf16 K/V reads
    and writes any head_dim that is a multiple of 8 up to 512 in place;
    any other head_dim runs padded (ops/dims.py::flash_head_dim: bf16 to
    64, 128, 256 or 512, f32 and quantized K/V to 64, 128 or 256) and out
    comes back at the true head_dim."""
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, _ = k.shape
    quantized = k_scales is not None or v_scales is not None
    if quantized:
        if k.dtype not in PAYLOAD_FORMATS or v.dtype != k.dtype \
                or q.dtype not in _KERNEL_DTYPES:
            raise NotImplementedError(
                f"the quantized CUDA forward takes bf16 or f32 q over int8 "
                f"or e4m3 k/v of one format, got {q.dtype}, {k.dtype}, "
                f"{v.dtype}")
        if seq_lengths is not None:
            raise NotImplementedError(
                "the jagged mode takes no quantized K/V (JAX's row loop has "
                "no quantized operands)")
        for s in (k_scales, v_scales):
            if s is None or s.dtype != torch.float32 \
                    or tuple(s.shape) != (bs, hkv, kv_len, 1):
                raise ValueError(f"k_scales and v_scales are f32 "
                                 f"{(bs, hkv, kv_len, 1)}")
    elif q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise NotImplementedError(
            f"the CUDA forward kernel takes bf16 or f32 q/k/v of one dtype "
            f"(int8 or e4m3 K/V with their scales), got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    dk = flash_head_dim(d, q.dtype, "the CUDA forward kernel",
                        quantized=quantized)
    if not (k.is_cuda and v.is_cuda and k.device == q.device
            and v.device == q.device):
        raise ValueError("q, k and v must be on one CUDA device")
    if k.shape != (bs, hkv, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"shapes {q.shape}, {k.shape}, {v.shape}")
    if q_len == 0 or kv_len == 0 or bs == 0:
        raise ValueError("empty q or kv")
    if dk != d:
        out, lse = launch_fwd(
            *(pad_head_dim(t, dk) for t in (q, k, v)), causal=causal,
            sm_scale=sm_scale, q_seg=q_seg, kv_seg=kv_seg, tiles=tiles,
            seq_lengths=seq_lengths, window=window, k_scales=k_scales,
            v_scales=v_scales, config=config)
        return unpad_head_dim(out, d), lse
    cfg = fwd_config(q.dtype, quantized, d)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if quantized:
        if any(s.device != q.device for s in (k_scales, v_scales)):
            raise ValueError("the scales must be on q's device")
        scales = [_scale_rows(s) for s in (k_scales, v_scales)]
    out = torch.empty_like(q)
    lse = torch.empty((bs, hq, q_len), dtype=torch.float32, device=q.device)
    scale_log2 = in_dtype(sm_scale * LOG2E, q.dtype)
    work, n_items, n_slots = None, 0, 0
    if q.dtype == torch.float32:
        # the f32 instance takes the pruned ranges and their order from its
        # work list, not from the tile table
        work, n_items, n_slots = _device_fwd_work(
            q_len, kv_len, bool(causal), window,
            None if tiles is None else tiles.starts, bs * hq, cfg,
            config, (configs.FLASH_FWD_F32_SPLIT_BELOW,
                     configs.FLASH_FWD_F32_MAX_SLOTS), str(q.device))
        tiles = None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (q_seg, kv_seg,
                        *((None, None) if tiles is None
                          else tiles.table(cfg)))))
    dims = (bs, hq, hkv, q_len, kv_len, d, int(causal), window or 0,
            n_items)
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        runs = (None, None, None)
        if work is not None:
            ws = (fwd_workspace(q.device, stream, n_slots, bs * hq,
                                -(-q_len // cfg.block_m), d, cfg.block_m)
                  if n_slots else (None, None))
            runs = (work.data_ptr(),
                    *(None if t is None else t.data_ptr() for t in ws))
        if quantized:
            err = _flash_fwd_quant_fn()(
                *ptrs, *(s.data_ptr() for s in scales), *runs,
                scales[0].shape[-1], *dims, scale_log2,
                PAYLOAD_FORMATS[k.dtype], _KERNEL_DTYPES[q.dtype], stream)
        else:
            err = _flash_fwd_fn()(
                *ptrs, None if seq_lengths is None else seq_lengths.data_ptr(),
                *runs, *dims, scale_log2, _KERNEL_DTYPES[q.dtype],
                int(config.narrow_products), stream)
    _build.check(err, "flash_fwd_quant" if quantized else "flash_fwd")
    return out, lse
