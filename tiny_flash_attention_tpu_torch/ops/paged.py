"""Decode attention over separate K and V page arrays: plain version, kernel.

Counterpart of tiny_flash_attention_tpu/ops/paged.py::paged_decode_attention,
the paged decode of the north-star's "paged KV decode" configuration
(benchmarks/attention_bench.py:146-168). K and V live in two page arrays
(kv_heads, num_pages, page_size, d) of q's dtype, or as int8
`QuantizedTensor`s whose f32 scales are pages (kv_heads, num_pages,
page_size, 1). A CPU tensor takes the plain version (`paged_decode_plain`,
the fused decode's arithmetic over these arrays); a CUDA tensor launches
csrc/paged_decode_separate.cu, the split decode kernel of
csrc/paged_decode.cuh over this layout (csrc/paged_decode_separate_widths.cu
at a head_dim or page size without an instance of its own,
ops/dims.py::decode_width; above 256 csrc/paged_decode_separate_wide.cu
for bf16 q and paged_decode_separate_f32_wide.cu for f32 q), or raises. It
takes every head_dim up to 512 with q in bf16 or f32, every page size the
JAX package takes (any for pages of q's dtype, a
multiple of 128 for int8 pages) and any GQA group, the q rows padded as in
ops/paged_fused.py.

Two divergences from JAX, where its output is unwritten: a length of 0
gives out 0 and the LSE sentinel, and a length past the table width
attends the whole table (the TPU kernel's epilogue is never reached in
either case).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.dims import (
    WIDE_HEAD_DIM, decode_compiled, decode_group, decode_q_head_dim,
    pad_group, unpad_group)
from tiny_flash_attention_tpu_torch.ops.flash import LOG2E, in_dtype
from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    decode_plain, decode_splits, decode_workspace, split_args, token_pages)
from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _split(pages):
    """(values, scales (hkv, N, ps) or None) of a page array."""
    if isinstance(pages, QuantizedTensor):
        return pages.values, pages.scales[..., 0]
    return pages, None


def paged_decode_attention(q: torch.Tensor, k_pages, v_pages,
                           lengths: torch.Tensor,
                           page_indices: torch.Tensor, *,
                           sm_scale: Optional[float] = None,
                           pages_per_block: Optional[int] = None):
    """Single-token decode attention over a paged KV cache.

    q: (batch, q_heads, d). k_pages, v_pages: (kv_heads, num_pages,
    page_size, d) of q's dtype, or QuantizedTensors with int8 values of
    that shape and f32 scales (kv_heads, num_pages, page_size, 1), whose
    page_size must be a multiple of 128 (as in JAX). lengths: (batch,) int,
    the tokens of each sequence; page_indices (batch, pages_per_seq).
    pages_per_block is the TPU kernel's tile of pages: it must divide
    pages_per_seq, as there, and changes no result. On the card each
    sequence's tokens are split over blocks of
    ops/configs.py::paged_decode_split_pages pages, as in the fused decode.
    Returns (out (batch, q_heads, d), lse (batch, q_heads) f32).
    """
    quantized = isinstance(k_pages, QuantizedTensor)
    if isinstance(v_pages, QuantizedTensor) != quantized:
        raise ValueError("K and V pages must both be quantized or neither")
    k, k_scale = _split(k_pages)
    v, v_scale = _split(v_pages)
    batch, hq, d = q.shape
    hkv, num_pages, page_size, _ = k.shape
    if v.shape != k.shape or k.shape[-1] != d or page_size < 1:
        raise ValueError(f"k pages {tuple(k.shape)}, v pages "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    if quantized:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError("quantized pages hold int8 values")
        if page_size % 128:
            raise ValueError(f"quantized paged KV needs page_size % 128 == "
                             f"0, got {page_size}")
        if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3] \
                or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32:
            raise ValueError("scales must be f32 (kv_heads, num_pages, "
                             "page_size, 1)")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    pages_per_seq = page_indices.shape[1]
    if pages_per_block is not None and (
            pages_per_block < 1 or pages_per_seq % pages_per_block):
        raise ValueError(f"pages_per_block {pages_per_block} does not "
                         f"divide pages_per_seq {pages_per_seq}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        return forward_only(
            "paged_decode_attention",
            lambda: _decode_cuda(q, k, v, k_scale, v_scale, lengths,
                                 page_indices, sm_scale=sm_scale), q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return paged_decode_plain(q, k_pages, v_pages, lengths, page_indices,
                              sm_scale=sm_scale)


# kernel launches, either format; width_launches those on a run-time width
# instance (ops/dims.py::decode_compiled)
paged_decode_attention.launches = 0
paged_decode_attention.width_launches = 0


def paged_decode_plain(q, k_pages, v_pages, lengths, page_indices, *,
                       sm_scale: float, splits: Optional[int] = None,
                       out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version with the kernel's arithmetic (`decode_plain`
    of ops/paged_fused.py over the tokens below each clamped length; with
    `splits` (a count, or "kernel"), over the kernel's splits, merged in
    order; out in `out_dtype`, q's by default). Runs on any device;
    gathers the whole table."""
    k, k_scale = _split(k_pages)
    v, v_scale = _split(v_pages)
    ids, rows, valid = token_pages(lengths, page_indices, k.shape[2])
    return decode_plain(
        q, k[:, ids, rows], v[:, ids, rows],
        None if k_scale is None else k_scale[:, ids, rows],
        None if v_scale is None else v_scale[:, ids, rows], valid,
        sm_scale=sm_scale, out_dtype=out_dtype,
        **split_args(lengths, page_indices, k.shape[2], None, splits))


def _decode_source(d: int, page_size: int, dtype: torch.dtype) -> str:
    """The source of the instances that read head_dim d at page_size for q
    of `dtype` (above 256, those of width 512 of q's dtype, compiled and
    run-time alike; above 512 it raises, ops/dims.py::decode_q_head_dim)."""
    decode_q_head_dim(d, dtype)
    if d > WIDE_HEAD_DIM:
        return ("paged_decode_separate_wide" if dtype == torch.bfloat16
                else "paged_decode_separate_f32_wide")
    return ("paged_decode_separate" if decode_compiled(d, page_size)
            else "paged_decode_separate_widths")


def _decode_fn(source: str):
    fn = getattr(_build.library(source), f"tfa_{source}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _decode_cuda(q, k, v, k_scale, v_scale, lengths, page_indices, *,
                 sm_scale: float):
    """Launches csrc/paged_decode_separate.cu, or its run-time width or
    (above head_dim 256) width-512 twin (`_decode_source`); returns (out,
    lse)."""
    batch, hq, d = q.shape
    hkv, num_pages, page_size, _ = k.shape
    quantized = k_scale is not None
    if q.dtype not in _KERNEL_DTYPES or not (
            (quantized and k.dtype == torch.int8)
            or (k.dtype == q.dtype and v.dtype == q.dtype)):
        raise NotImplementedError(
            f"the CUDA decode kernel takes bf16 or f32 q over pages of q's "
            f"dtype or int8 pages, got {q.dtype} and {k.dtype}")
    source = _decode_source(d, page_size, q.dtype)
    dev = q.device
    tensors = [k, v, lengths, page_indices] + (
        [k_scale, v_scale] if quantized else [])
    if not all(t.device == dev for t in tensors):
        raise ValueError("q, pages, scales, lengths and page_indices must be "
                         "on one CUDA device")
    if lengths.shape != (batch,) or page_indices.dim() != 2 \
            or page_indices.shape[0] != batch:
        raise ValueError(f"lengths {tuple(lengths.shape)}, page_indices "
                         f"{tuple(page_indices.shape)} for batch {batch}")
    for t in (k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("pages must be contiguous and 16-byte aligned")
    if quantized and not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                             for t in (k_scale, v_scale)):
        raise ValueError("scale pages must be contiguous and 16-byte "
                         "aligned")
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if quantized
              else (None, None))
    group, (rows, blocks) = hq // hkv, decode_group(hq // hkv, d)
    q = pad_group(q.contiguous(), hkv, rows * blocks)
    lengths = lengths.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32)
    if page_indices.stride(1) != 1:
        page_indices = page_indices.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
    P = page_indices.shape[1]
    per, n_splits = decode_splits(P, page_size)
    with _build.on_device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ws = decode_workspace(dev, stream, batch, hkv * blocks, n_splits,
                              rows, d)
        err = _decode_fn(source)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
            lengths.data_ptr(), page_indices.data_ptr(),
            page_indices.stride(0), P, n_splits, per, out.data_ptr(),
            lse.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(), batch,
            q.shape[1], hkv, blocks, num_pages, page_size, d,
            in_dtype(sm_scale * LOG2E, q.dtype), _KERNEL_DTYPES[q.dtype],
            int(quantized), stream)
    _build.check(err, source)
    paged_decode_attention.launches += 1
    paged_decode_attention.width_launches += not decode_compiled(
        d, page_size)
    return unpad_group(out, hkv, group), unpad_group(lse, hkv, group)
