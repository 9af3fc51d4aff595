"""Fused-page decode attention and token append: page format, plain
versions, kernels.

Counterpart of tiny_flash_attention_tpu/ops/paged_fused.py. A page packs one
page of K and V in one block, byte-identical to the JAX format:

    rows [0, ps)               K payload (ps tokens x d)
    rows [ps, 2ps)             V payload
    rows [2ps, 2ps + sr)       K per-token f32 scales, bit-packed  (int8 only)
    rows [2ps + sr, 2ps + 2sr) V per-token f32 scales               (int8 only)

with sr = scale_rows_per_side(ps, d) = 4 * ceil(ps / d) and byte j of
token i's scale at [4 * (i // d) + j, i % d]. bf16 pages hold the model
dtype (bf16 or f32). `fused_paged_decode_attention` attends one new token
per sequence through a page table; `fused_page_append` writes one token per
(kv head, sequence) in place (quantized for int8 pages). A CPU tensor takes
the plain version, a CUDA tensor launches csrc/paged_decode.cu or, for
f32 q, csrc/paged_decode_f32.cu (ports `_fused_decode_kernel`, its
sliding-window ring mode included; at a head_dim or page size those do
not compile, csrc/paged_decode_widths.cu / paged_decode_widths_f32.cu; at
head dims in (256, 512], bf16 q only, csrc/paged_decode_wide.cu) or
csrc/page_append.cu (ports `_append_kernel`) or raises.

The decode kernel splits each sequence's tokens over several blocks
(page-aligned ranges of the table, `decode_splits`) and merges their
partial softmax states in split order; `fused_paged_decode_plain(...,
splits=k)` computes the same partials and merge. Both kernels read rows of
any head_dim up to 512 (the decode with f32 q up to 256) in place (pages
are never padded) at every page size the JAX package takes
(`kernel_page_size`); 64, 80, 96, 128, 256 and 512 at page size 16 or a
multiple of 32 on instances of their own, every other on the run-time
width instances (ops/dims.py::decode_width). The decode compiles 1, 2, 4
or 8 q rows a kv head (4 above 128, ops/dims.py::DECODE_TOP_512 above 256)
and takes any GQA group by padding each kv head's q rows to the next of
them, or to row blocks of the top above, and slicing out and the LSE back
(ops/dims.py), as JAX pads them to 8.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.configs import (
    decode_split_plan, paged_decode_split_pages, window_pages)
from tiny_flash_attention_tpu_torch.ops.dims import (
    DECODE_HEAD_DIMS, WIDE_HEAD_DIM, decode_compiled, decode_group,
    decode_head_dim, decode_q_head_dim, pad_group, unpad_group)
from tiny_flash_attention_tpu_torch.ops.flash import LN2, LOG2E, in_dtype
from tiny_flash_attention_tpu_torch.ops.quant import quantize_int8
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_PAGE_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def kernel_page_size(page_size: int, d: int, fmt: str) -> bool:
    """Whether the decode and append kernels take fused pages of this page
    size at head_dim d: every geometry the JAX package takes. Pages of bf16
    or f32, any page size >= 1; int8 pages, page_size <= head_dim or a
    multiple of it (tiny_flash_attention_tpu/ops/paged_fused.py:76-83,
    `scale_rows_per_side`: a group of scale bytes never straddles rows)."""
    if page_size < 1:
        return False
    return fmt != "int8" or page_size <= d or page_size % d == 0


# --- page packing ------------------------------------------------------------


def pack_kv_page_bf16(k_page: torch.Tensor,
                      v_page: torch.Tensor) -> torch.Tensor:
    """(..., ps, d) + (..., ps, d) -> (..., 2ps, d) fused page."""
    return torch.cat([k_page, v_page], dim=-2)


def scale_rows_per_side(page_size: int, d: int) -> int:
    """int8 rows holding one side's per-token f32 scales (4 * ceil(ps / d));
    ps > d must be a multiple of d (a scale group never straddles rows)."""
    if page_size <= d:
        return 4
    if page_size % d:
        raise ValueError(
            f"int8 fused pages need page_size <= head_dim or a multiple of "
            f"it ({page_size}, {d})")
    return 4 * (page_size // d)


def page_rows(page_size: int, d: int, fmt: str) -> int:
    """Rows of one fused page: 2ps, plus 2 * sr scale rows for int8."""
    if fmt == "bf16":
        return 2 * page_size
    if fmt == "int8":
        return 2 * page_size + 2 * scale_rows_per_side(page_size, d)
    raise ValueError(f"KV format {fmt!r}")


def _quant_rows(x: torch.Tensor):
    """(..., d) -> (int8 payload, f32 scale (...,)), per token row."""
    qt = quantize_int8(x, axis=-1)
    return qt.values, qt.scales[..., 0]


def _pack_scale_rows(scales: torch.Tensor, d: int) -> torch.Tensor:
    """(..., ps) f32 -> (..., scale_rows_per_side(ps, d), d) int8: byte j of
    token i at [4 * (i // d) + j, i % d] (the f32's little-endian bytes)."""
    ps = scales.shape[-1]
    lead = scales.shape[:-1]
    b = scales.float().contiguous().view(torch.int8).reshape(*lead, ps, 4)
    if ps <= d:
        return F.pad(b.transpose(-1, -2), (0, d - ps))   # (..., 4, d)
    groups = ps // d
    b = b.reshape(*lead, groups, d, 4).transpose(-1, -2)  # (..., g, 4, d)
    return b.reshape(*lead, 4 * groups, d)


def _unpack_scale_rows(rows: torch.Tensor, page_size: int) -> torch.Tensor:
    """(..., sr, d) int8 scale rows -> (..., page_size) f32 scales."""
    sr, d = rows.shape[-2:]
    lead = rows.shape[:-2]
    b = rows.reshape(*lead, sr // 4, 4, d).transpose(-1, -2).contiguous()
    return b.view(torch.float32).reshape(*lead, (sr // 4) * d)[
        ..., :page_size]


def quantize_kv_page_int8(k_page: torch.Tensor,
                          v_page: torch.Tensor) -> torch.Tensor:
    """(..., ps, d) K and V float pages -> (..., 2ps + 2sr, d) int8 pages,
    per-token scales packed into the scale rows."""
    ps, d = k_page.shape[-2:]
    scale_rows_per_side(ps, d)   # validates the geometry
    kq, ks = _quant_rows(k_page)
    vq, vs = _quant_rows(v_page)
    return torch.cat([kq, vq, _pack_scale_rows(ks, d),
                      _pack_scale_rows(vs, d)], dim=-2)


def pack_paged_cache(k_pages: torch.Tensor, v_pages: torch.Tensor,
                     fmt: str = "bf16") -> torch.Tensor:
    """(hkv, np, ps, d) K and V page arrays -> fused pages array."""
    if fmt == "bf16":
        return pack_kv_page_bf16(k_pages, v_pages)
    if fmt == "int8":
        return quantize_kv_page_int8(k_pages, v_pages)
    raise ValueError(fmt)


def unpack_int8_pages(pages: torch.Tensor, page_size: int):
    """int8 fused pages (..., 2ps + 2sr, d) -> (k, v, k_scale, v_scale): the
    int8 payloads (..., ps, d) and the f32 scales (..., ps)."""
    ps = page_size
    sr = (pages.shape[-2] - 2 * ps) // 2
    return (pages[..., :ps, :], pages[..., ps:2 * ps, :],
            _unpack_scale_rows(pages[..., 2 * ps:2 * ps + sr, :], ps),
            _unpack_scale_rows(pages[..., 2 * ps + sr:, :], ps))


# --- token append ------------------------------------------------------------


def fused_page_append(fused_pages: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, page_ids: torch.Tensor,
                      rows: torch.Tensor, *, page_size: int) -> torch.Tensor:
    """Appends one token per sequence into the fused pages, IN PLACE.

    fused_pages: (hkv, num_pages, prows, d), int8 pages quantize the rows.
    k_new/v_new: (B, hkv, d) in bf16 or f32. page_ids/rows: (B,) int, the
    target page and row in it. Returns fused_pages. A CPU tensor takes the
    plain version (page_append_plain); a CUDA tensor launches
    csrc/page_append.cu or raises.
    """
    hkv, num_pages, prows, d = fused_pages.shape
    fmt = "int8" if fused_pages.dtype == torch.int8 else "bf16"
    _check_page_size(page_size, d, fmt)
    if prows != page_rows(page_size, d, fmt):
        raise ValueError(f"pages {tuple(fused_pages.shape)} do not hold "
                         f"{fmt} pages of page_size {page_size}")
    batch = k_new.shape[0]
    if k_new.shape != (batch, hkv, d) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new {tuple(k_new.shape)}, v_new "
                         f"{tuple(v_new.shape)} for pages "
                         f"{tuple(fused_pages.shape)}")
    if fused_pages.is_cuda:
        return _append_cuda(fused_pages, k_new, v_new, page_ids, rows,
                            page_size=page_size)
    if fused_pages.device.type != "cpu":
        raise ValueError(f"unsupported device {fused_pages.device}")
    return page_append_plain(fused_pages, k_new, v_new, page_ids, rows,
                             page_size=page_size)


# counted by _append_cuda: every launch, and width_launches those at a
# head_dim with no instance of its own (the run-time head_dim instance)
fused_page_append.launches = 0
fused_page_append.width_launches = 0


def _check_page_size(page_size: int, d: int, fmt: str) -> None:
    """Raises ValueError where the JAX package refuses the page geometry
    (`kernel_page_size`), on any device."""
    if not kernel_page_size(page_size, d, fmt):
        raise ValueError(
            f"{fmt} fused pages of page_size {page_size} at head_dim {d}: "
            f"the page size must be >= 1, and for int8 pages <= head_dim or "
            f"a multiple of it (as in JAX)")


def page_append_plain(pages: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, page_ids: torch.Tensor,
                      rows: torch.Tensor, *, page_size: int) -> torch.Tensor:
    """The scatter decomposition of the append (the JAX engine's
    `_append_rows_scatter`), in place: the payload rows, and for int8 pages
    the quantized rows and the 4 bytes of each f32 scale per side. Runs on
    any device."""
    ps = page_size
    page_ids, rows = page_ids.long(), rows.long()
    kt, vt = k_new.transpose(0, 1), v_new.transpose(0, 1)   # (hkv, B, d)
    if pages.dtype != torch.int8:
        pages[:, page_ids, rows] = kt.to(pages.dtype)
        pages[:, page_ids, ps + rows] = vt.to(pages.dtype)
        return pages
    d = pages.shape[-1]
    sr = scale_rows_per_side(ps, d)
    kq, ks = _quant_rows(kt)
    vq, vs = _quant_rows(vt)
    pages[:, page_ids, rows] = kq
    pages[:, page_ids, ps + rows] = vq
    srow = 2 * ps + 4 * (rows // d)
    lane = rows % d
    ksb = ks.contiguous().view(torch.int8).reshape(*ks.shape, 4)
    vsb = vs.contiguous().view(torch.int8).reshape(*vs.shape, 4)
    for j in range(4):
        pages[:, page_ids, srow + j, lane] = ksb[..., j]
        pages[:, page_ids, sr + srow + j, lane] = vsb[..., j]
    return pages


def _append_fn():
    fn = _build.library("page_append").tfa_page_append
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _append_cuda(pages, k_new, v_new, page_ids, rows, *, page_size: int):
    """Launches csrc/page_append.cu; returns pages (updated in place)."""
    hkv, num_pages, prows, d = pages.shape
    batch = k_new.shape[0]
    if k_new.dtype not in _KERNEL_DTYPES or v_new.dtype != k_new.dtype \
            or pages.dtype not in _PAGE_DTYPES:
        raise NotImplementedError(
            f"the CUDA append kernel takes bf16 or f32 rows into bf16, f32 "
            f"or int8 pages, got {k_new.dtype}, {v_new.dtype} into "
            f"{pages.dtype}")
    decode_head_dim(d, "the CUDA append kernel")
    dev = pages.device
    if not all(t.device == dev for t in (k_new, v_new, page_ids, rows)):
        raise ValueError("pages, rows and targets must be on one CUDA "
                         "device")
    if page_ids.shape != (batch,) or rows.shape != (batch,):
        raise ValueError(f"page_ids {tuple(page_ids.shape)}, rows "
                         f"{tuple(rows.shape)} for batch {batch}")
    if not pages.is_contiguous():
        raise ValueError("fused pages must be contiguous (they are updated "
                         "in place)")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    page_ids = page_ids.to(torch.int32).contiguous()
    rows = rows.to(torch.int32).contiguous()
    with _build.on_device(dev):
        err = _append_fn()(
            k_new.data_ptr(), v_new.data_ptr(), page_ids.data_ptr(),
            rows.data_ptr(), pages.data_ptr(), batch, hkv, num_pages, prows,
            page_size, d, _KERNEL_DTYPES[k_new.dtype],
            _PAGE_DTYPES[pages.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "page_append")
    fused_page_append.launches += 1
    fused_page_append.width_launches += d not in DECODE_HEAD_DIMS
    return pages


# --- decode attention --------------------------------------------------------


def fused_paged_decode_attention(q: torch.Tensor, fused_pages: torch.Tensor,
                                 lengths: torch.Tensor,
                                 page_indices: torch.Tensor, *,
                                 page_size: int,
                                 sm_scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """Decode attention over fused KV pages.

    q: (batch, q_heads, d). fused_pages: (kv_heads, num_pages, rows, d),
    rows = 2*page_size for pages of q's dtype, 2*page_size + 2*sr for int8
    pages. lengths: (batch,) int32, the tokens each sequence holds.
    page_indices: (batch, pages_per_seq) int32; a column slice of a wider
    table is fine. Without a window each sequence attends its first
    min(length, pages_per_seq * page_size) tokens. With `window` (the JAX
    ring mode) it attends [length - window, length), length unclamped, and
    token t lies on the table's page (t // page_size) % pages_per_seq: the
    table is a ring, and window <= pages_per_seq * page_size. On the card
    each sequence's tokens are split over blocks of
    ops/configs.py::paged_decode_split_pages pages (`decode_splits`); on
    the CPU the plain version runs unsplit. Returns (out (batch, q_heads,
    d), lse (batch, q_heads) f32).
    """
    batch, hq, d = q.shape
    hkv, num_pages, rows, d2 = fused_pages.shape
    fmt = "int8" if fused_pages.dtype == torch.int8 else "bf16"
    _check_page_size(page_size, d, fmt)
    if rows != page_rows(page_size, d, fmt) or d2 != d:
        raise ValueError(f"pages {tuple(fused_pages.shape)} do not hold "
                         f"{fmt} pages of page_size {page_size} and d {d}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    _check_window(window, page_indices.shape[1] * page_size)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        return forward_only(
            "fused_paged_decode_attention",
            lambda: _decode_cuda(q, fused_pages, lengths, page_indices,
                                 page_size=page_size, sm_scale=sm_scale,
                                 window=window),
            q, fused_pages)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return fused_paged_decode_plain(q, fused_pages, lengths, page_indices,
                                    page_size=page_size, sm_scale=sm_scale,
                                    window=window)


# counted by _decode_cuda: launches without a window over pages of q's
# dtype, int8_launches over int8 pages, ring_launches with a window (either
# format); width_launches counts those of them that ran on a run-time width
# instance (ops/dims.py::decode_compiled)
fused_paged_decode_attention.launches = 0
fused_paged_decode_attention.int8_launches = 0
fused_paged_decode_attention.ring_launches = 0
fused_paged_decode_attention.width_launches = 0


def _check_window(window: Optional[int], capacity: int) -> None:
    if window is not None and not 1 <= window <= capacity:
        raise ValueError(f"window {window} outside [1, {capacity}], the "
                         f"ring's capacity (pages_per_seq * page_size)")


def token_positions(lengths: torch.Tensor, pages_per_seq: int,
                    page_size: int, window: Optional[int] = None):
    """(positions, valid), each (batch, T): the position of every token a
    decode attends, in order. Without a window T is the table's capacity
    P * page_size and token t is valid below min(length, T); with one,
    T = window, the tokens are [length - window, length) (valid from 0,
    positions clamped to 0)."""
    P = pages_per_seq
    dev = lengths.device
    n = lengths.long()[:, None]
    if window is None:
        pos = torch.arange(P * page_size, device=dev)[None, :].expand(
            n.shape[0], -1)
        valid = pos < n.clamp(max=P * page_size)
    else:
        pos = n - window + torch.arange(window, device=dev)[None, :]
        valid = pos >= 0
        pos = pos.clamp(min=0)
    return pos, valid


def token_pages(lengths: torch.Tensor, page_indices: torch.Tensor,
                page_size: int, window: Optional[int] = None):
    """(page ids, rows, valid), each (batch, T): the page and row of every
    token a decode attends, in order (`token_positions`); with a window
    token t lies on logical page (t // page_size) % P."""
    P = page_indices.shape[1]
    pos, valid = token_positions(lengths.to(page_indices.device), P,
                                 page_size, window)
    ids = torch.gather(page_indices.long(), 1, (pos // page_size) % P)
    return ids, pos % page_size, valid


def decode_splits(pages_per_seq: int, page_size: int,
                  window: Optional[int] = None,
                  splits: Optional[int] = None) -> tuple[int, int]:
    """(pages a split, splits) of a decode: the splits cover the table's
    pages, or with a window the pages the window touches counted from the
    page of its first token. By default a split holds
    ops/configs.py::paged_decode_split_pages pages; `splits` asks for a
    count instead. Each split holds whole pages."""
    pages = (pages_per_seq if window is None
             else window_pages(window, page_size))
    if splits is None:
        per = paged_decode_split_pages(page_size)
        return per, -(-pages // per)
    return decode_split_plan(pages, splits)


def token_splits(lengths: torch.Tensor, pages_per_seq: int, page_size: int,
                 window: Optional[int], pages_per_split: int):
    """(batch, T): the split of every token of `token_positions` (its
    page, counted from the table's first or the window's first, over
    pages_per_split)."""
    pos, _ = token_positions(lengths, pages_per_seq, page_size, window)
    page = pos // page_size
    if window is not None:
        first = (lengths.long()[:, None] - window).clamp(min=0)
        page = page - first // page_size
    return page // pages_per_split


def decode_plain(q, k_tok, v_tok, k_scale, v_scale, valid, *,
                 sm_scale: float, split_of=None, n_splits: int = 1,
                 out_dtype: Optional[torch.dtype] = None):
    """The decode kernels' arithmetic over gathered tokens: k_tok/v_tok
    (hkv, batch, T, d), int8 payloads with f32 scales k_scale/v_scale
    (hkv, batch, T) or pages of q's dtype with scales None, valid (batch,
    T). q is scaled by sm_scale*log2(e) in its dtype, the softmax runs in
    the log2 domain with the mask value and empty-row guard, and p is cast
    to q's dtype before the PV product. int8 (paged_fused.py:389-436 and
    paged.py:176-210 of the JAX package): the payload converts exactly, the
    f32 scores are multiplied by the K scales, l sums the unscaled p, and p
    times the V scales in f32 is what is cast before the PV product.
    With split_of (batch, T), each token's split in [0, n_splits): the
    softmax state (m, l, acc) of each split over its own tokens, then the
    exact LSE combine of the splits in split order, as the kernels do.
    Returns (out (batch, hq, d) in `out_dtype`, q's by default, and lse
    (batch, hq)); out in f32 is the model before the kernels' last
    rounding."""
    batch, hq, d = q.shape
    hkv = k_tok.shape[0]
    c = in_dtype(sm_scale * LOG2E, q.dtype)
    qs = (q.float() * c).to(q.dtype).float().reshape(batch, hkv, hq // hkv,
                                                      d)
    kk = k_tok.transpose(0, 1).to(q.dtype).float()     # (B, hkv, T, d)
    vv = v_tok.transpose(0, 1).to(q.dtype).float()
    s = torch.matmul(qs, kk.transpose(-1, -2))          # (B, hkv, G, T)
    if k_scale is not None:
        s = s * k_scale.transpose(0, 1)[:, :, None, :]
    vsc = None if v_scale is None else v_scale.transpose(0, 1)[:, :, None,
                                                                  :]
    if split_of is None:
        split_of, n_splits = torch.zeros_like(valid, dtype=torch.long), 1
    m_f = num = den = None
    for x in range(n_splits):   # in split order
        mine = valid & (split_of == x)
        sx = torch.where(mine[:, None, None, :], s, DEFAULT_MASK_VALUE)
        m = sx.amax(dim=-1, keepdim=True)
        p = torch.exp2(sx - m) * (m > 0.5 * DEFAULT_MASK_VALUE)
        l = p.sum(dim=-1, keepdim=True)
        pv = p if vsc is None else p * vsc
        acc = torch.matmul(pv.to(q.dtype).float(), vv)
        if m_f is None:
            m_f, num, den = m, acc, l
            continue
        m_new = torch.maximum(m_f, m)
        w_old, w_x = torch.exp2(m_f - m_new), torch.exp2(m - m_new)
        m_f, num, den = m_new, num * w_old + acc * w_x, den * w_old + l * w_x
    l_safe = torch.where((den == 0.0) | torch.isnan(den), 1.0, den)
    out = num / l_safe
    lse = m_f[..., 0] * LN2 + torch.log(l_safe[..., 0])
    return (out.to(out_dtype or q.dtype).reshape(batch, hq, d),
            lse.reshape(batch, hq))


def split_args(lengths, page_indices, page_size: int,
               window: Optional[int], splits) -> dict:
    """decode_plain's split arguments: none for splits None; the kernel's
    default splits for "kernel"; else `splits` asked."""
    if splits is None:
        return {}
    if splits == "kernel":
        splits = None
    P = page_indices.shape[1]
    per, n = decode_splits(P, page_size, window, splits)
    return {"split_of": token_splits(lengths.to(page_indices.device), P,
                                     page_size, window, per),
            "n_splits": n}


def fused_paged_decode_plain(q, fused_pages, lengths, page_indices, *,
                             page_size: int, sm_scale: float,
                             window: Optional[int] = None,
                             splits: Optional[int] = None,
                             out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of the fused-page decode (`decode_plain` over
    the tokens of `token_pages`, ring mode included); with `splits`, over
    the kernel's splits of the tokens (`decode_splits`: a count asked, or
    "kernel" for the kernel's default), merged in order; out in
    `out_dtype` (q's by default). Runs on any device; gathers every token
    it attends, and without a window the whole table."""
    ps = page_size
    ids, rows, valid = token_pages(lengths, page_indices, ps, window)
    kw = split_args(lengths, page_indices, ps, window, splits)
    if fused_pages.dtype != torch.int8:
        return decode_plain(q, fused_pages[:, ids, rows],
                            fused_pages[:, ids, ps + rows], None, None,
                            valid, sm_scale=sm_scale, out_dtype=out_dtype,
                            **kw)
    _, _, ksc, vsc = unpack_int8_pages(fused_pages, ps)   # (hkv, N, ps)
    return decode_plain(q, fused_pages[:, ids, rows],
                        fused_pages[:, ids, ps + rows], ksc[:, ids, rows],
                        vsc[:, ids, rows], valid, sm_scale=sm_scale,
                        out_dtype=out_dtype, **kw)


_workspaces: dict = {}


def decode_workspace(device, stream: int, batch: int, kv_heads: int,
                     splits: int, group: int, d: int):
    """(partials f32, arrival counters int32 zeros) of the split decode,
    for `kv_heads` block rows (kv heads x q row blocks) of `group` q rows
    (the padded group, ops/dims.py::decode_group),
    allocated once per device, stream and shape and kept: the kernel
    leaves the counters at zero, so a call allocates nothing (a later CUDA
    graph can capture it). Launches on one stream run in order, so they
    share a workspace; another stream gets its own. A launch that dies
    part way leaves counters set, and a later call on that stream and
    shape would merge early: such a fault leaves the CUDA context unusable
    anyway. `stream` is the launch's CUDA stream handle."""
    key = (str(device), stream, batch, kv_heads, splits, group, d)
    ws = _workspaces.get(key)
    if ws is None:
        ws = (torch.empty(batch * kv_heads * splits * group * (d + 2),
                          dtype=torch.float32, device=device),
              torch.zeros(batch * kv_heads, dtype=torch.int32,
                          device=device))
        _workspaces[key] = ws
    return ws


# the source and entry of each q dtype's instances of the compiled widths
# and of the run-time widths, and of bf16 q's at width 512, compiled and
# run-time (built in parallel)
DECODE_ENTRIES = {torch.bfloat16: ("paged_decode", "tfa_paged_decode"),
                  torch.float32: ("paged_decode_f32", "tfa_paged_decode_f32")}
DECODE_WIDTH_ENTRIES = {
    torch.bfloat16: ("paged_decode_widths", "tfa_paged_decode_widths"),
    torch.float32: ("paged_decode_widths_f32",
                    "tfa_paged_decode_widths_f32")}
DECODE_WIDE_ENTRY = ("paged_decode_wide", "tfa_paged_decode_wide")


def decode_entry(dtype: torch.dtype, d: int, page_size: int):
    """(source, entry) of the fused decode's instances that read head_dim d
    at page_size for q of `dtype` (ops/dims.py::decode_compiled; above
    head_dim 256 the source of width 512, bf16 q only: others raise,
    ops/dims.py::decode_q_head_dim)."""
    decode_q_head_dim(d, dtype)
    if d > WIDE_HEAD_DIM:
        return DECODE_WIDE_ENTRY
    entries = (DECODE_ENTRIES if decode_compiled(d, page_size)
               else DECODE_WIDTH_ENTRIES)
    return entries[dtype]


def _decode_fn(dtype: torch.dtype, d: int, page_size: int):
    source, entry = decode_entry(dtype, d, page_size)
    fn = getattr(_build.library(source), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _decode_cuda(q, fused_pages, lengths, page_indices, *, page_size: int,
                 sm_scale: float, window: Optional[int]):
    """Launches csrc/paged_decode.cu (bf16 q) or csrc/paged_decode_f32.cu
    (f32 q), or their run-time width or (above head_dim 256) width-512
    twins (`decode_entry`); returns (out, lse)."""
    batch, hq, d = q.shape
    hkv, num_pages, prows = fused_pages.shape[:3]
    quantized = fused_pages.dtype == torch.int8
    if q.dtype not in _KERNEL_DTYPES or not (
            quantized or fused_pages.dtype == q.dtype):
        raise NotImplementedError(
            f"the CUDA decode kernel takes bf16 or f32 q over pages of q's "
            f"dtype or int8 pages, got {q.dtype} and {fused_pages.dtype}")
    source, _ = decode_entry(q.dtype, d, page_size)
    dev = q.device
    if not (fused_pages.device == dev and lengths.device == dev
            and page_indices.device == dev):
        raise ValueError("q, pages, lengths and page_indices must be on "
                         "one CUDA device")
    if lengths.shape != (batch,) or page_indices.dim() != 2 \
            or page_indices.shape[0] != batch:
        raise ValueError(f"lengths {tuple(lengths.shape)}, page_indices "
                         f"{tuple(page_indices.shape)} for batch {batch}")
    if not fused_pages.is_contiguous() or fused_pages.data_ptr() % 16:
        raise ValueError("fused pages must be contiguous and 16-byte "
                         "aligned (they are updated in place)")
    group, (rows, blocks) = hq // hkv, decode_group(hq // hkv, d)
    q = pad_group(q.contiguous(), hkv, rows * blocks)
    lengths = lengths.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32)
    if page_indices.stride(1) != 1:
        page_indices = page_indices.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
    scale_log2 = in_dtype(sm_scale * LOG2E, q.dtype)
    P = page_indices.shape[1]
    per, n_splits = decode_splits(P, page_size, window)
    with _build.on_device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ws = decode_workspace(dev, stream, batch, hkv * blocks, n_splits,
                              rows, d)
        err = _decode_fn(q.dtype, d, page_size)(
            q.data_ptr(), fused_pages.data_ptr(), lengths.data_ptr(),
            page_indices.data_ptr(), page_indices.stride(0), P, n_splits,
            per, out.data_ptr(), lse.data_ptr(), ws[0].data_ptr(),
            ws[1].data_ptr(), batch, q.shape[1], hkv, blocks, num_pages,
            page_size, prows, d, window or 0, scale_log2,
            _KERNEL_DTYPES[q.dtype], int(quantized), stream)
    _build.check(err, source)
    fused_paged_decode_attention.width_launches += not decode_compiled(
        d, page_size)
    if window is not None:
        fused_paged_decode_attention.ring_launches += 1
    elif quantized:
        fused_paged_decode_attention.int8_launches += 1
    else:
        fused_paged_decode_attention.launches += 1
    return unpad_group(out, hkv, group), unpad_group(lse, hkv, group)
