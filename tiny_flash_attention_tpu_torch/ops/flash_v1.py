"""FlashAttention-1 forward: the FA1 loop order, its plain version, its kernel.

Counterpart of tiny_flash_attention_tpu/ops/flash_v1.py::flash_attention_v1,
the teaching kernel that keeps the KV-outer loop order beside the FA2
forward (ops/flash.py) so that the gap between the two stays visible. A CPU
tensor takes the plain version (`flash_attention_v1_plain`); a CUDA tensor
launches csrc/flash_v1.cu, which keeps FA1's order on the card (KV tiles
outer, every q tile's running state in a global scratch reloaded on each KV
step; bf16 on wgmma and TMA, f32 on the CUDA cores, each block's q tiles
from `v1_schedule` at its instance's tiles), or raises. The kernel compiles
head_dim 64, 128 and 256 (the wide instances, on smaller tiles: 64-row kv
tiles in bf16, 32-row q and kv tiles in f32); other head dims up to 256
run padded with zero columns (ops/dims.py), as in the forward.

One divergence from JAX: every row that sees no column (causal with q_len >
kv_len) gets out 0 and the LSE sentinel (mask value) * ln2. JAX gives that
only in q tiles that some KV tile reaches and leaves -inf in the others, a
result that depends on its block size.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from tiny_flash_attention_tpu_torch import _build
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_V1_BF16, FLASH_V1_BF16_Q_TILES, FLASH_V1_BF16_WIDE, FLASH_V1_F32,
    FLASH_V1_F32_Q_TILES, FLASH_V1_F32_WIDE, TileConfig, v1_smem_bytes)
from tiny_flash_attention_tpu_torch.ops.dims import (
    FLASH_HEAD_DIMS, WIDE_HEAD_DIM, kernel_head_dim, pad_head_dim,
    unpad_head_dim)
from tiny_flash_attention_tpu_torch.ops.flash import (
    LN2, LOG2E, _aligned, in_dtype)
from tiny_flash_attention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE, causal_mask)
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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


# kernel launches, counted by _v1_cuda; f32_launches those of the f32
# instance
flash_attention_v1.launches = 0
flash_attention_v1.f32_launches = 0


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


def kv_tile_counts(q_len: int, kv_len: int, causal: bool, block_m: int,
                   block_n: int) -> np.ndarray:
    """The kv tiles [0, hi) each q tile visits, as the kernel counts them
    (csrc/flash_common.cuh::kv_tiles): up to the causal clamp of its last
    row, at least one, so rows that precede every kv position still get
    the sentinel."""
    n_all = -(-kv_len // block_n)
    q0 = np.arange(-(-q_len // block_m), dtype=np.int64) * block_m
    if not causal:
        return np.full(q0.shape, n_all, np.int64)
    last = np.minimum(q0 + block_m, q_len) - 1 + (kv_len - q_len)
    return np.where(last < 0, 1, np.minimum(n_all, last // block_n + 1))


def v1_schedule(q_len: int, kv_len: int, causal: bool,
                block_m: int = FLASH_V1_BF16.block_m,
                block_n: int = FLASH_V1_BF16.block_n,
                per_block: int = FLASH_V1_BF16_Q_TILES) -> np.ndarray:
    """The q tiles of each FA1 block, (blocks, per_block) int32, -1 for
    none: the tiles longest first (most kv tiles to visit), dealt to
    ceil(n / per_block) blocks in snake order (0 .. B-1, then B-1 .. 0),
    so that each block's kv steps add up to about the same (causal: block
    i takes tiles n-1-i and i). Every q tile appears once. The defaults
    are the bf16 kernel's tiles; `v1_config` gives each instance's."""
    work = kv_tile_counts(q_len, kv_len, causal, block_m, block_n)
    n_blocks = -(-work.size // per_block)
    table = np.full((n_blocks, per_block), -1, np.int32)
    for rank, tile in enumerate(np.argsort(-work, kind="stable")):
        rnd, pos = divmod(rank, n_blocks)
        table[pos if rnd % 2 == 0 else n_blocks - 1 - pos, rnd] = tile
    return table


def v1_config(dtype: torch.dtype,
              head_dim: int = 128) -> tuple[TileConfig, int]:
    """The FA1 kernel's tiles for q's dtype at the tiles' head_dim (64,
    128 or 256: above 128 the wide instance's) and its q tiles a block."""
    wide = head_dim > FLASH_HEAD_DIMS[-1]
    if dtype == torch.bfloat16:
        return (FLASH_V1_BF16_WIDE if wide else FLASH_V1_BF16,
                FLASH_V1_BF16_Q_TILES)
    return FLASH_V1_F32_WIDE if wide else FLASH_V1_F32, FLASH_V1_F32_Q_TILES


def v1_state_floats(dtype: torch.dtype, bh: int, q_len: int, d: int) -> int:
    """f32 scratch of the kernel's running state at the tiles' head_dim d,
    one slot per (head, q tile): bf16, block_m * (d + 8) floats a 128-row
    tile (each consumer thread's accumulator fragments and its (m, m', l,
    l')); f32, block_m * d + 128 a 64-row tile (32-row at 256; each PV
    thread's accumulator tile, and the (m, l) of its row group's rows once
    for each warp the group spans: 2 x 64 rows, or 2 x 2 x 32 at 256)."""
    cfg, _ = v1_config(dtype, d)
    bm = cfg.block_m
    slot = bm * (d + 8) if dtype == torch.bfloat16 else bm * d + 128
    return bh * -(-q_len // bm) * slot


@functools.lru_cache(maxsize=64)
def _device_schedule(q_len, kv_len, causal, dtype, head_dim, device):
    cfg, per_block = v1_config(dtype, head_dim)
    return torch.as_tensor(v1_schedule(q_len, kv_len, causal, cfg.block_m,
                                       cfg.block_n, per_block),
                           device=device)


def check_smem_layout(lib: ctypes.CDLL) -> None:
    """Holds `v1_smem_bytes` to the shared memory the library's instances
    take (`tfa_flash_v1_smem`, from the kernels' own layouts) for both
    dtypes and every head_dim, the wide one included; raises where they
    differ."""
    smem = lib.tfa_flash_v1_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    for dtype, code in _KERNEL_DTYPES.items():
        for d in (*FLASH_HEAD_DIMS, WIDE_HEAD_DIM):
            cfg, _ = v1_config(dtype, d)
            want = v1_smem_bytes(cfg, d)
            if smem(code, d) != want:
                raise RuntimeError(
                    f"ops/configs.py::v1_smem_bytes gives {want} bytes for "
                    f"{cfg} at head_dim {d}; the kernel takes "
                    f"{smem(code, d)}")


def _v1_fn():
    lib = _build.library("flash_v1")
    fn = lib.tfa_flash_v1
    if fn.argtypes is None:
        check_smem_layout(lib)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                ctypes.c_longlong]
                       + [ctypes.c_int] * 5
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
    dk = kernel_head_dim(d, "the CUDA FA1 kernel", wide=True)
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one CUDA device")
    if q_len == 0 or kv_len == 0 or b * h == 0:
        raise ValueError("empty q or kv")
    if dk != d:
        out, lse = _v1_cuda(*(pad_head_dim(t, dk) for t in (q, k, v)),
                            causal=causal, sm_scale=sm_scale)
        return unpad_head_dim(out, d), lse
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    dev = q.device
    n = v1_state_floats(q.dtype, b * h, q_len, d)
    state = torch.empty(n, dtype=torch.float32, device=dev)
    sched = _device_schedule(q_len, kv_len, bool(causal), q.dtype, d,
                             str(dev))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=dev)
    with _build.on_device(dev):
        err = _v1_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), state.data_ptr(), sched.data_ptr(),
            sched.shape[0], n,
            b * h, q_len, kv_len, d, int(causal),
            in_dtype(sm_scale * LOG2E, q.dtype), _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_v1")
    flash_attention_v1.launches += 1
    if q.dtype == torch.float32:
        flash_attention_v1.f32_launches += 1
    return out, lse
