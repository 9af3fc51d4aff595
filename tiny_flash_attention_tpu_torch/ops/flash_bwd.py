"""Flash-attention backward: the public entry, its plain version, its kernel.

Counterpart of the JAX package's five backward entry points, which compute
one contract and differ only in TPU scheduling:
`ops/flash_tri_bwd.py::tri_flash_bwd` and `::tri_flash_bwd_banded`,
`ops/flash_bwd.py::_flash_bwd_fused` and `::flash_attention_bwd` (its split
dq and dk/dv kernels). One Hopper source, csrc/flash_bwd.cu, ports all five
as two kernels (dq, and dk/dv summed over the GQA group). A CPU tensor takes
the plain version; a CUDA tensor takes the kernels or raises for what they
do not do yet (sliding window, segment ids, quantized K/V, head_dim other
than 64 or 128). There is no fallback from the card to the plain version.

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
import math
from typing import Optional

import torch

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.flash import (
    LOG2E, _KERNEL_DTYPES, _KERNEL_HEAD_DIMS, _aligned, in_dtype)
from tiny_flash_attention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE, causal_mask)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool,
                        sm_scale: Optional[float] = None):
    """Gradients of flash attention: returns (dq, dk, dv).

    Args:
      q, out, do: (batch, q_heads, q_len, head_dim)
      k, v: (batch, kv_heads, kv_len, head_dim); q_heads % kv_heads == 0
      lse: the forward's natural-log LSE (batch, q_heads, q_len) f32
      causal: row i sits at position i + kv_len - q_len (decode offset)
      sm_scale: softmax scale, default 1/sqrt(head_dim)

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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    do = do.to(q.dtype)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                               sm_scale=sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                     sm_scale=sm_scale)


# calls that launched the kernels, counted by _flash_bwd_cuda; each call
# launches flash_bwd_dq and flash_bwd_dkv once
flash_attention_bwd.launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool,
                              sm_scale: float):
    """Plain PyTorch backward with the kernels' arithmetic and rounding
    points (the FA2 identities of flash_bwd.py:9-15). Runs on any device;
    materializes the (q_len, kv_len) scores of every head, and frees each
    such tensor once it is used (at 8 heads of 8192 each is 2.1 GB)."""
    bs, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    group = hq // hkv
    dt = q.dtype
    kr = k.repeat_interleave(group, dim=1) if group > 1 else k
    vr = v.repeat_interleave(group, dim=1) if group > 1 else v
    qs = (q * in_dtype(sm_scale * LOG2E, dt)).to(dt)
    s2 = torch.matmul(qs.float(), kr.float().transpose(-1, -2))
    if causal:
        s2 = torch.where(causal_mask(q_len, kv_len, q.device), s2,
                         DEFAULT_MASK_VALUE)
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


def _flash_bwd_fn():
    fn = _build.library("flash_bwd").tfa_flash_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, do, lse, delta, *, dq, dk, dv, causal: bool,
            sm_scale: float) -> None:
    """One call of csrc/flash_bwd.cu on checked, contiguous inputs: the dq
    kernel if `dq` is a tensor, the dk/dv kernel if `dk` and `dv` are."""
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, _ = k.shape
    ptr = (lambda t: None if t is None else t.data_ptr())
    with _build.on_device(q.device):
        err = _flash_bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ptr(dq), ptr(dk), ptr(dv),
            bs, hq, hkv, q_len, kv_len, d, int(causal),
            in_dtype(sm_scale * LOG2E, q.dtype), sm_scale,
            _KERNEL_DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_bwd")


def _bwd_inputs(q, k, v, out, lse, do):
    """Checks the kernels' inputs; returns them contiguous and aligned,
    with delta = rowsum(do * out) in f32."""
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, _ = k.shape
    if q.dtype not in _KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in (k, v, out, do)):
        raise NotImplementedError(
            f"the CUDA backward kernels take bf16 or f32 tensors of one "
            f"dtype (quantized K/V are not ported yet), got {q.dtype}, "
            f"{k.dtype}, {v.dtype}, {out.dtype}, {do.dtype}")
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
    delta = (do.float() * out.float()).sum(-1)
    return (_aligned(q), _aligned(k), _aligned(v), _aligned(do),
            _aligned(lse), delta)


def _flash_bwd_cuda(q, k, v, out, lse, do, *, causal: bool, sm_scale: float):
    """Launches both kernels of csrc/flash_bwd.cu; returns (dq, dk, dv)."""
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, out, lse, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch(q, k, v, do, lse, delta, dq=dq, dk=dk, dv=dv, causal=causal,
            sm_scale=sm_scale)
    flash_attention_bwd.launches += 1
    return dq, dk, dv
