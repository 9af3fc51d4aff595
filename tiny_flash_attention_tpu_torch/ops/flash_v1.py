"""FlashAttention-1 forward: the FA1 loop order, its plain version, its kernel.

Counterpart of tiny_flash_attention_tpu/ops/flash_v1.py::flash_attention_v1,
the teaching kernel that keeps the KV-outer loop order beside the FA2
forward (ops/flash.py) so that the gap between the two stays visible. A CPU
tensor takes the plain version (`flash_attention_v1_plain`); a CUDA tensor
launches csrc/flash_v1.cu, which keeps FA1's order on the card (KV tiles
outer, every q tile's running state in a global scratch reloaded on each KV
step), or raises.

One divergence from JAX: every row that sees no column (causal with q_len >
kv_len) gets out 0 and the LSE sentinel (mask value) * ln2. JAX gives that
only in q tiles that some KV tile reaches and leaves -inf in the others, a
result that depends on its block size.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_V1_BF16, FLASH_V1_F32)
from tiny_flash_attention_tpu_torch.ops.flash import (
    LN2, LOG2E, _aligned, in_dtype)
from tiny_flash_attention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE, causal_mask)
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_v1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False,
                       sm_scale: Optional[float] = None,
                       block_q: int = 512, block_kv: int = 512,
                       return_lse: bool = False):
    """FA1-loop-order forward (the teaching tier; flash_attention is the
    production forward).

    q (b, h, q_len, d); k, v (b, h, kv_len, d): no GQA, as in JAX. Causal
    rows sit at position i + kv_len - q_len. block_q and block_kv are the
    TPU kernel's tiles; they change no result here (the Hopper kernel's
    tiles are ops/configs.py's FLASH_V1_*). Returns out, and with
    return_lse also the natural-log LSE (b, h, q_len) f32.
    """
    b, h, q_len, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: flash_attention_v1 takes q, k "
                         f"and v of one head count (no GQA)")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"block sizes {block_q}, {block_kv}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        out, lse = forward_only(
            "flash_attention_v1",
            lambda: _v1_cuda(q, k, v, causal=causal, sm_scale=sm_scale),
            q, k, v)
    elif q.device.type == "cpu":
        out, lse = flash_attention_v1_plain(q, k, v, causal=causal,
                                            sm_scale=sm_scale)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (out, lse) if return_lse else out


flash_attention_v1.launches = 0   # kernel launches, counted by _v1_cuda


def flash_attention_v1_plain(q, k, v, *, causal: bool, sm_scale: float):
    """Plain PyTorch version with the kernel's rounding points: q scaled by
    sm_scale*log2(e) in q's dtype, the softmax in the log2 domain in f32
    (one pass over all columns, where the kernel streams them), p cast to
    v's dtype before the PV product, LSE m*ln2 + log(l); rows that see no
    column give out 0 and the sentinel. Returns (out, lse); runs on any
    device."""
    q_len, kv_len = q.shape[2], k.shape[2]
    c = in_dtype(sm_scale * LOG2E, q.dtype)
    qs = (q.float() * c).to(q.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if causal:
        s = torch.where(causal_mask(q_len, kv_len, q.device), s,
                        DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * (m > 0.5 * DEFAULT_MASK_VALUE)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where((l == 0.0) | torch.isnan(l), 1.0, l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = m[..., 0] * LN2 + torch.log(l_safe[..., 0])
    return out.to(q.dtype), lse


def _v1_fn():
    fn = _build.library("flash_v1").tfa_flash_v1
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _v1_cuda(q, k, v, *, causal: bool, sm_scale: float):
    """Launches csrc/flash_v1.cu; returns (out, lse)."""
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise NotImplementedError(
            f"the CUDA FA1 kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d}: the CUDA FA1 kernel takes "
                                  f"{_KERNEL_HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one CUDA device")
    if q_len == 0 or kv_len == 0 or b * h == 0:
        raise ValueError("empty q or kv")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bm = (FLASH_V1_BF16 if q.dtype == torch.bfloat16 else FLASH_V1_F32).block_m
    rows = -(-q_len // bm) * bm
    dev = q.device
    m = torch.empty((b * h, rows), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b * h, rows, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=dev)
    with _build.on_device(dev):
        err = _v1_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(), rows,
            b * h, q_len, kv_len, d, int(causal),
            in_dtype(sm_scale * LOG2E, q.dtype), _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_v1")
    flash_attention_v1.launches += 1
    return out, lse
