"""INT8 / FP8 quantization: per-row and per-block scales, weight-only matmul.

Port of tiny_flash_attention_tpu/ops/quant.py. A QuantizedTensor holds a
low-bit payload (int8 or float8_e4m3fn) and f32 scales that broadcast
against it: per token row (..., s, 1) for a KV cache, per output channel
(1, n) for a projection weight. Both frameworks round half to even, so the
payloads equal the JAX package's byte for byte; XLA may compute amax / 127
one ulp away from the IEEE quotient, so scales agree to 1 ulp.

`quantized_matmul` is the weight-only projection. A CPU tensor takes its
plain version. On the card the route is chosen by the activation's row
count (`ops/configs.py::QUANT_MATMUL_MAX_ROWS`): decode rows launch the
hand-written kernel (ops/quant_matmul.py), which reads the int8/e4m3 weight
once; prefill rows are a large product, which converts the payload to the
activation dtype and hands it to cuBLAS with f32 output, the scale applied
in f32 afterwards (the JAX package leaves that product to XLA too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tiny_flash_attention_tpu_torch.ops.configs import QUANT_MATMUL_MAX_ROWS
from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
    quantized_matmul_cuda, quantized_matmul_plain)

INT8_MAX = 127.0
FP8_E4M3_MAX = 448.0


@dataclasses.dataclass
class QuantizedTensor:
    """Low-bit payload + f32 scales (scales broadcast against values)."""
    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.values.float() * self.scales).to(dtype)


def _amax_scale(x: torch.Tensor, dim, qmax: float) -> torch.Tensor:
    """amax / qmax by IEEE division (1 where amax is 0). The divisor is a
    tensor on amax's device: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can land an ulp away."""
    amax = x.float().abs().amax(dim=dim, keepdim=True)
    return torch.where(amax == 0.0, 1.0, amax / torch.full_like(amax, qmax))


def _round_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


def quantize_int8(x: torch.Tensor, axis=-1,
                  block: Optional[int] = None) -> QuantizedTensor:
    """Symmetric INT8. axis: reduction axis or axes of the scale (default:
    per row over the last dim). block: optional group size along `axis`
    (one scale per `block` consecutive elements, broadcast to x's shape)."""
    if block is not None:
        ax = axis if axis >= 0 else x.dim() + axis
        if x.shape[ax] % block:
            raise ValueError(f"axis {ax} of {tuple(x.shape)} is not a "
                             f"multiple of block {block}")
        shp = x.shape[:ax] + (x.shape[ax] // block, block) + x.shape[ax + 1:]
        xb = x.reshape(shp)
        scale = _amax_scale(xb, ax + 1, INT8_MAX)
        return QuantizedTensor(_round_int8(xb, scale).reshape(x.shape),
                               scale.expand(shp).reshape(x.shape))
    scale = _amax_scale(x, axis, INT8_MAX)
    return QuantizedTensor(_round_int8(x, scale), scale)


def quantize_fp8(x: torch.Tensor, axis=-1) -> QuantizedTensor:
    """FP8 e4m3 with per-row f32 scales (scaled to e4m3's range)."""
    scale = _amax_scale(x, axis, FP8_E4M3_MAX)
    return QuantizedTensor((x.float() / scale).to(torch.float8_e4m3fn),
                           scale)


_QUANTIZERS = {"int8": quantize_int8, "fp8": quantize_fp8}


def quantize_kv(k: torch.Tensor, v: torch.Tensor, fmt: str = "int8"):
    """Quantizes a KV cache with per-token-row scales (..., s, 1)."""
    qfn = _QUANTIZERS[fmt]
    return qfn(k, axis=-1), qfn(v, axis=-1)


# --- weight-only quantized projections ---------------------------------------


def quantize_weight(w: torch.Tensor, fmt: str = "int8") -> QuantizedTensor:
    """Per-output-channel scales (1, d_out) for a (d_in, d_out) weight."""
    return _QUANTIZERS[fmt](w, axis=0)


def quantized_matmul(x: torch.Tensor, qw: QuantizedTensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., K) @ dequant(qw (K, N)) -> (..., N) in out_dtype (default
    x's): the product of x and the payload converted to x's dtype,
    accumulated in f32, times the (1, N) scales in f32, rounded once."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, qw, out_dtype)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if x2.shape[0] <= QUANT_MATMUL_MAX_ROWS:
        out = quantized_matmul_cuda(x2, qw, out_dtype)
    else:
        out = _large_product(x2, qw, out_dtype)
    return out.reshape(*lead, out.shape[-1])


def _large_product(x: torch.Tensor, qw, out_dtype) -> torch.Tensor:
    """Prefill rows: the payload converted exactly to x's dtype, a cuBLAS
    product with f32 output (`torch.mm(..., out_dtype=)`), then the scale."""
    w = qw.values.to(x.dtype)
    if x.dtype == torch.float32:
        acc = torch.mm(x, w)
    else:
        acc = torch.mm(x, w, out_dtype=torch.float32)
    return (acc * qw.scales.float()).to(out_dtype)
