"""Decode attention over separate K and V page arrays: plain version, kernel.

Counterpart of tiny_flash_attention_tpu/ops/paged.py::paged_decode_attention,
the paged decode of the north-star's "paged KV decode" configuration
(benchmarks/attention_bench.py:146-168). K and V live in two page arrays
(kv_heads, num_pages, page_size, d) of q's dtype, or as int8
`QuantizedTensor`s whose f32 scales are pages (kv_heads, num_pages,
page_size, 1). A CPU tensor takes the plain version (`paged_decode_plain`,
the fused decode's arithmetic over these arrays); a CUDA tensor launches
csrc/paged_decode_separate.cu, the decode kernel of csrc/paged_decode.cuh
over this layout, or raises.

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
from tiny_flash_attention_tpu_torch.ops.flash import LOG2E, in_dtype
from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    decode_plain, token_pages)
from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_GROUPS = (1, 2, 4, 8)


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
    pages_per_seq, as there, and changes no result.
    Returns (out (batch, q_heads, d), lse (batch, q_heads) f32).
    """
    quantized = isinstance(k_pages, QuantizedTensor)
    if isinstance(v_pages, QuantizedTensor) != quantized:
        raise ValueError("K and V pages must both be quantized or neither")
    k, k_scale = _split(k_pages)
    v, v_scale = _split(v_pages)
    batch, hq, d = q.shape
    hkv, num_pages, page_size, _ = k.shape
    if v.shape != k.shape or k.shape[-1] != d:
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


paged_decode_attention.launches = 0   # kernel launches, either format


def paged_decode_plain(q, k_pages, v_pages, lengths, page_indices, *,
                       sm_scale: float):
    """Plain PyTorch version with the kernel's arithmetic (`decode_plain`
    of ops/paged_fused.py over the tokens below each clamped length). Runs
    on any device; gathers the whole table."""
    k, k_scale = _split(k_pages)
    v, v_scale = _split(v_pages)
    ids, rows, valid = token_pages(lengths, page_indices, k.shape[2])
    return decode_plain(
        q, k[:, ids, rows], v[:, ids, rows],
        None if k_scale is None else k_scale[:, ids, rows],
        None if v_scale is None else v_scale[:, ids, rows], valid,
        sm_scale=sm_scale)


def _decode_fn():
    fn = _build.library("paged_decode_separate").tfa_paged_decode_separate
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _decode_cuda(q, k, v, k_scale, v_scale, lengths, page_indices, *,
                 sm_scale: float):
    """Launches csrc/paged_decode_separate.cu; returns (out, lse)."""
    batch, hq, d = q.shape
    hkv, num_pages, page_size, _ = k.shape
    quantized = k_scale is not None
    if q.dtype not in _KERNEL_DTYPES or not (
            (quantized and k.dtype == torch.int8)
            or (k.dtype == q.dtype and v.dtype == q.dtype)):
        raise NotImplementedError(
            f"the CUDA decode kernel takes bf16 or f32 q over pages of q's "
            f"dtype or int8 pages, got {q.dtype} and {k.dtype}")
    if d not in _KERNEL_HEAD_DIMS or hq // hkv not in _KERNEL_GROUPS:
        raise NotImplementedError(
            f"head_dim {d}, group {hq // hkv}: the CUDA decode kernel takes "
            f"head_dim {_KERNEL_HEAD_DIMS} and group {_KERNEL_GROUPS}")
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
    if quantized and not (k_scale.is_contiguous()
                          and v_scale.is_contiguous()):
        raise ValueError("scale pages must be contiguous")
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if quantized
              else (None, None))
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32)
    if page_indices.stride(1) != 1:
        page_indices = page_indices.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((batch, hq), dtype=torch.float32, device=dev)
    with _build.on_device(dev):
        err = _decode_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
            lengths.data_ptr(), page_indices.data_ptr(),
            page_indices.stride(0), page_indices.shape[1], out.data_ptr(),
            lse.data_ptr(), batch, hq, hkv, num_pages, page_size, d,
            in_dtype(sm_scale * LOG2E, q.dtype), _KERNEL_DTYPES[q.dtype],
            int(quantized), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_decode_separate")
    paged_decode_attention.launches += 1
    return out, lse
