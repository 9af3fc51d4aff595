"""Weight-only quantized matmul for decode rows: plain version and kernel.

Counterpart of tiny_flash_attention_tpu/ops/quant_matmul.py::
quantized_matmul_pallas. x (M, K) in bf16 or f32 times an int8 or e4m3
weight (K, N) with per-output-channel f32 scales (1, N). The product runs
on x's dtype with the payload converted exactly (int8 and e4m3 values are
all representable in bf16), accumulates in f32, multiplies the scales in
f32 and rounds once to the output dtype (quant.py:116-118 of the JAX
package). At decode rows the function is bound by the weight's bytes: the
kernel (csrc/quant_matmul.cu) reads each weight byte once and never writes
a converted copy, which an eager `values.to(bf16)` + matmul would (three
times the int8 bytes). With bf16 x it converts the payload in registers and
multiplies on the tensor cores (mma.sync, the weight as the 16-row
operand); with f32 x on the CUDA cores. `qw` is any object with `.values`
and `.scales`.
"""

from __future__ import annotations

import ctypes

import torch

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.configs import (
    QUANT_MATMUL_MAX_SPLITS, quant_matmul_splits)
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

_X_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_W_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_ROW_BUCKETS = (1, 2, 4, 8, 16)


def quantized_matmul_plain(x: torch.Tensor, qw, out_dtype=None):
    """x (..., K) @ values (K, N) on x's dtype with f32 accumulation, times
    scales in f32, rounded once to out_dtype (default x's). Runs on any
    device; in f32, so its products and sums are exact up to f32 order."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    w = qw.values.to(x.dtype).float()
    acc = torch.matmul(x.float(), w)
    return (acc * qw.scales.float()).to(out_dtype)


def _matmul_fn():
    fn = _build.library("quant_matmul").tfa_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def quantized_matmul_cuda(x: torch.Tensor, qw, out_dtype=None, *,
                          splits=None):
    """Launches csrc/quant_matmul.cu on x (M, K), M <= 16 rows; returns
    (M, N) in out_dtype (default x's). splits: the K slices (default
    ops/configs.py::quant_matmul_splits). Raises NotImplementedError on
    what the kernel does not take, and at backward() (the Pallas kernel
    has no VJP; `ops/quant.py::quantized_matmul` is differentiable)."""
    return forward_only(
        "quantized_matmul_cuda",
        lambda: _matmul_cuda(x, qw, out_dtype, splits), x)


def _matmul_cuda(x, qw, out_dtype, splits):
    out_dtype = x.dtype if out_dtype is None else out_dtype
    values, scales = qw.values, qw.scales
    if x.dim() != 2 or values.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and values "
                         f"{tuple(values.shape)} must be 2-D")
    m, k = x.shape
    kw, n = values.shape
    if k != kw or tuple(scales.shape) != (1, n):
        raise ValueError(f"x {tuple(x.shape)}, values {tuple(values.shape)}"
                         f", scales {tuple(scales.shape)}")
    if x.dtype not in _X_DTYPES or out_dtype != x.dtype:
        raise NotImplementedError(
            f"the quantized matmul kernel takes bf16 or f32 x and returns "
            f"x's dtype, got {x.dtype} -> {out_dtype}")
    if values.dtype not in _W_DTYPES or scales.dtype != torch.float32:
        raise NotImplementedError(
            f"the quantized matmul kernel takes int8 or float8_e4m3fn "
            f"values with f32 scales, got {values.dtype}, {scales.dtype}")
    if not 1 <= m <= _ROW_BUCKETS[-1] or n % 8 or k < 1:
        raise NotImplementedError(
            f"the quantized matmul kernel takes 1..{_ROW_BUCKETS[-1]} rows "
            f"and N a multiple of 8, got M {m}, N {n}")
    dev = x.device
    if not (values.device == dev and scales.device == dev):
        raise ValueError("x, values and scales must be on one CUDA device")
    if not values.is_contiguous() or values.data_ptr() % 16:
        raise ValueError("values must be contiguous and 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    scales = scales.contiguous()
    if scales.data_ptr() % 16:
        scales = scales.clone()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    rows = next(b for b in _ROW_BUCKETS if b >= m)
    splits = quant_matmul_splits(n, k, m) if splits is None else splits
    if not 1 <= splits <= min(QUANT_MATMUL_MAX_SPLITS, k):
        raise ValueError(f"splits {splits} for K {k}")
    with _build.on_device(dev):
        err = _matmul_fn()(
            x.data_ptr(), values.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, k, n, _X_DTYPES[x.dtype] * 2
            + _W_DTYPES[values.dtype], rows, splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "quant_matmul")
    quantized_matmul_cuda.launches += 1
    return out


quantized_matmul_cuda.launches = 0


def convert_codes(fmt: str, device) -> torch.Tensor:
    """Every payload code as the bf16-x kernel converts it, on the card:
    (2, 256) bf16, row 0 a code in the low half of a converted pair, row 1
    in the high half (indexed by code, 0..255 as unsigned bytes)."""
    fn = _build.library("quant_matmul").tfa_quant_convert_codes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty(512, dtype=torch.bfloat16, device=device)
    with _build.on_device(out.device):
        err = fn(int(fmt == "fp8"), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "quant_matmul codes")
    return out.view(2, 256)
