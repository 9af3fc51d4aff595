"""Flash attention over a quantized (int8 / fp8-e4m3) KV cache.

Counterpart of tiny_flash_attention_tpu/ops/flash_quant.py::
flash_attention_quantized, the TPU work-list forward (`_fwd_kernel`) and the
two triangle kernels with K/V arriving as 1-byte payloads beside per-token
f32 scales (b, hkv, kv_len, 1). The scales fold around the two products and
no dequantized cache is ever written to device memory:

    s = (q @ k_payload^T) * k_scale^T      before the mask
    o += (p * v_scale^T) @ v_payload       after l has summed the bare p

On CUDA the quantized instances of B1 run (csrc/flash_fwd_quant.cu): with
bf16 q, B1's own wgmma/TMA kernel (csrc/flash_fwd_wgmma.cuh), whose producer
warpgroup loads the payload rows, converts them two bytes an instruction
(`convert_pairs` mirrors that arithmetic here) and stores them as the
ring's bf16 stage, while the consumers read the scales; with f32 q, the
CUDA-core body of csrc/flash_fwd.cuh. Each takes head_dim 64, 128 and 256
(the wide instances' tiles); other head dims up to 256 run padded with
code-0 payload columns and zero q columns (ops/dims.py), above 256 it
raises. The triangle kernels' regime (causal
q_len == kv_len >= 1024) takes the same launch, as B2 and B3 do in
`flash_attention`. On the CPU the plain version,
`flash_attention_quantized_plain`, runs.

The payload converts as JAX's `_payload_to_compute` does (`payload_to_compute`
here): int8 exactly, e4m3 to f32 exactly, and e4m3 to bf16 by JAX's integer
mapping, which lands the subnormal codes 0x01-0x07 high and maps the NaN
codes 0x7F/0xFF to +/-480; the port computes what the TPU kernel computes,
not Hopper's exact convert.

Forward only, as in JAX (its VJP covers unquantized K/V alone): on CUDA a
backward through the entry raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tiny_flash_attention_tpu_torch.ops import flash as F
from tiny_flash_attention_tpu_torch.ops.configs import (
    FlashConfig, resolve_config)
from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor
from tiny_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only


def payload_to_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A K/V payload in the compute dtype, as the TPU kernels convert it
    (flash.py:59-80): e4m3 -> bf16 rebuilds the bf16 bits from the code
    (sign << 8 | ((mag << 4) + (120 << 7)), mag 0 a signed zero); every
    other pair converts exactly."""
    if x.dtype == dtype:
        return x
    if x.dtype == torch.float8_e4m3fn and dtype == torch.bfloat16:
        u = x.view(torch.uint8).to(torch.int32)
        sign = (u & 0x80) << 8
        mag = u & 0x7F
        bits = torch.where(mag == 0, sign, sign | ((mag << 4) + (120 << 7)))
        bits = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)
        return bits.to(torch.int16).view(torch.bfloat16)
    return x.to(dtype)


def _bf16_half(words: torch.Tensor, shift: int) -> torch.Tensor:
    """The bf16 in bits [shift, shift + 16) of int64 words, as f32."""
    b = (words >> shift) & 0xFFFF
    b = torch.where(b >= 1 << 15, b - (1 << 16), b)
    return b.to(torch.int16).view(torch.bfloat16).float()


def convert_pairs(pairs: torch.Tensor, fmt: str) -> torch.Tensor:
    """The bf16 kernel's payload conversion (csrc/flash_fwd_wgmma.cuh,
    `int8_pair_bf16` and `e4m3_pair_bf16`), step by step in int64: `pairs`
    holds two payload bytes each (the first in bits 0-7); returns their
    bf16 bits, (..., 2) int64, the first byte's first. int8: h = 0x4300 |
    (x & 0x7F) and g = 0xC300 | (x & 0x80) as bf16, summed by a bf16 fma
    with 1.0 (exact). e4m3: t = mag << 4, a mask from bit 15 of t + 0x7FF0,
    ((t + 0x3C00) & mask) | sign. `payload_to_compute` is the reference."""
    p = pairs.to(torch.int64) & 0xFFFF
    if fmt == "int8":
        lo = (p & 0xFF) | ((p >> 8) << 16)           # prmt 0x4140
        m = (lo & 0x007F007F) | 0x43004300
        g = (lo & 0x00800080) | 0xC300C300
        halves = []
        for sh in (0, 16):
            s = (_bf16_half(m, sh) * 1.0 + _bf16_half(g, sh)).to(
                torch.bfloat16)
            halves.append(s.view(torch.int16).to(torch.int64) & 0xFFFF)
        return torch.stack(halves, -1)
    if fmt != "fp8":
        raise ValueError(f"payload format {fmt!r}")
    hi = ((p & 0xFF) << 8) | ((p >> 8) << 24)        # prmt 0x1404
    t = (hi >> 4) & 0x07F007F0
    x = t + 0x7FF07FF0
    nz = torch.zeros_like(x)
    for bit, half in ((15, 0x0000FFFF), (31, 0xFFFF0000)):   # prmt 0xBB99
        nz = nz | torch.where((x >> bit) & 1 == 1, half, 0)
    out = ((t + 0x3C003C00) & nz) | (hi & 0x80008000)
    return torch.stack([out & 0xFFFF, (out >> 16) & 0xFFFF], -1)


def flash_attention_quantized(q: torch.Tensor, k: QuantizedTensor,
                              v: QuantizedTensor, *, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              segment_ids=None, window: Optional[int] = None,
                              segment_starts=None,
                              config: Optional[FlashConfig] = None,
                              return_lse: bool = False):
    """Flash attention with an int8 / fp8-e4m3 KV cache.

    Args:
      q: (batch, q_heads, q_len, head_dim) bf16 or f32 (fp16 computes in
        f32, as `flash_attention` does)
      k, v: QuantizedTensor, values (batch, kv_heads, kv_len, head_dim) int8
        or float8_e4m3fn, scales (batch, kv_heads, kv_len, 1) f32
      causal, sm_scale, segment_ids, window, segment_starts: as in
        `ops/flash.py::flash_attention` (segment_starts may be the
        `SegmentTiles` built once by `segment_tiles`)
      config: as in `flash_attention` (f32 q: its kv runs); checked before
        any launch, nothing on the CPU
      return_lse: also return the natural-log LSE (batch, q_heads, q_len)

    Returns out (like q), and lse if asked. Forward only, as in JAX: on
    CUDA a backward through it raises NotImplementedError.
    """
    bs, hq, q_len, d = q.shape
    kv_shape = tuple(k.values.shape)
    hkv, kv_len = kv_shape[1], kv_shape[2]
    if tuple(v.values.shape) != kv_shape or kv_shape[0] != bs \
            or kv_shape[3] != d:
        raise ValueError(f"shapes {tuple(q.shape)}, {kv_shape}, "
                         f"{tuple(v.values.shape)}")
    for t in (k, v):
        if t.values.dtype not in F.PAYLOAD_FORMATS:
            raise ValueError(f"payloads are int8 or float8_e4m3fn, got "
                             f"{t.values.dtype}")
        if tuple(t.scales.shape) != (bs, hkv, kv_len, 1):
            raise ValueError(f"scales {tuple(t.scales.shape)}: expected "
                             f"per-token {(bs, hkv, kv_len, 1)}")
    window = F.check_masks(hq, hkv, q_len, kv_len, causal=causal,
                           window=window, segment_ids=segment_ids,
                           segment_starts=segment_starts)
    config = resolve_config(config)
    if q.dtype == torch.float16:
        out = flash_attention_quantized(
            q.float(), k, v, causal=causal, sm_scale=sm_scale,
            segment_ids=segment_ids, window=window,
            segment_starts=segment_starts, config=config,
            return_lse=return_lse)
        if return_lse:
            return out[0].to(torch.float16), out[1]
        return out.to(torch.float16)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_quantized_plain(
            q, k.values, v.values, k.scales, v.scales, causal=causal,
            sm_scale=sm_scale, segment_ids=segment_ids, window=window,
            return_lse=return_lse)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    masks = F.kernel_masks(q, kv_len, causal=causal, window=window,
                           segment_ids=segment_ids,
                           segment_starts=segment_starts)

    def launch():
        out = F.launch_fwd(q, k.values, v.values, causal=causal,
                           sm_scale=sm_scale, k_scales=k.scales,
                           v_scales=v.scales, config=config, **masks)
        flash_attention_quantized.launches += 1
        if k.values.dtype == torch.int8:
            flash_attention_quantized.int8_launches += 1
        else:
            flash_attention_quantized.fp8_launches += 1
        return out
    out = forward_only("flash_attention_quantized", launch, q, k.scales,
                       v.scales)
    return out if return_lse else out[0]


# kernel launches, and those over int8 and over e4m3 payloads
flash_attention_quantized.launches = 0
flash_attention_quantized.int8_launches = 0
flash_attention_quantized.fp8_launches = 0


def flash_attention_quantized_plain(q, k, v, k_scales, v_scales, *,
                                    causal: bool, sm_scale: float,
                                    segment_ids=None,
                                    window: Optional[int] = None,
                                    return_lse: bool = False):
    """Plain PyTorch version with the kernel's rounding points: q scaled by
    sm_scale*log2(e) in q's dtype, the payloads converted to q's dtype
    (`payload_to_compute`), s in f32 times the k scales, then the mask at
    the mask value (never -inf), the softmax in the log2 domain, l summed
    from the bare p, then p times the v scales in f32, rounded once to q's
    dtype before the PV product, and out = pv / l. Rows that see no column
    give out 0 and the LSE sentinel (mask value) * ln2. One pass over all
    columns where the kernel streams them; runs on any device."""
    hq, q_len = q.shape[1], q.shape[2]
    hkv, kv_len = k.shape[1], k.shape[2]
    group = hq // hkv
    kc = payload_to_compute(k, q.dtype).float()
    vc = payload_to_compute(v, q.dtype).float()
    ks, vs = k_scales.float(), v_scales.float()
    if group > 1:
        kc, vc, ks, vs = (t.repeat_interleave(group, dim=1)
                          for t in (kc, vc, ks, vs))
    c = F.in_dtype(sm_scale * F.LOG2E, q.dtype)
    qs = (q.float() * c).to(q.dtype).float()
    s = torch.matmul(qs, kc.transpose(-1, -2)) * ks.transpose(-1, -2)
    valid = F.visible_mask(q_len, kv_len, q.device, causal=causal,
                           window=window, segment_ids=segment_ids)
    if valid is not None:
        s = torch.where(valid, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * (m > 0.5 * DEFAULT_MASK_VALUE)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    pv = torch.matmul((p * vs.transpose(-1, -2)).to(q.dtype).float(), vc)
    out = (pv / l_safe).to(q.dtype)
    if not return_lse:
        return out
    return out, m[..., 0] * F.LN2 + torch.log(l_safe[..., 0])
