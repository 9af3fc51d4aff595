"""Plain attention oracle ladder: the port of the JAX package's reference tier.

Counterpart of tiny_flash_attention_tpu/ops/reference.py (:58-297): the
naive, safe and online softmax rungs, the FA1 (KV-outer) and FA2 (Q-outer)
reference loop orders and `mha_reference` over (batch, heads, seq, d) with
GQA. JAX writes each rung for one head and `vmap`s it; here every rung takes
any leading dims (..., seq, d), so `mha_reference` only repeats the kv heads
and calls the rung. JAX's `lax.scan` over KV blocks is a Python loop over
them carrying (m, l, acc). The rounding points are JAX's: f32 scores, p cast
to v's dtype before the second product in the naive and safe rungs, f32
throughout the streaming ones, the `m > 0.5 * DEFAULT_MASK_VALUE` row guard
and the `(l == 0) | isnan(l)` epilogue. These are plain PyTorch: the oracle,
not kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """(q_len, kv_len) bool: row i sits at position i + kv_len - q_len and
    sees columns at or before it."""
    rows = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    cols = torch.arange(kv_len, device=device)[None, :]
    return cols <= rows


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """Scaled f32 scores (..., q_len, kv_len), causal columns masked."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        s = torch.where(causal_mask(q.shape[-2], k.shape[-2], q.device), s,
                        DEFAULT_MASK_VALUE)
    return s


def _pv(p: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(dtype)


def attention_naive(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Naive softmax attention over (..., q_len, d) x (..., kv_len, d):
    materializes the scores; fully-masked rows (causal, q_len > kv_len)
    output 0. Returns q's dtype."""
    s = _scores(q, k, causal, _scale(q, sm_scale))
    p = torch.softmax(s, dim=-1)
    q_len, kv_len = q.shape[-2], k.shape[-2]
    if causal and q_len > kv_len:
        valid = causal_mask(q_len, kv_len, q.device).any(-1, keepdim=True)
        p = torch.where(valid, p, 0.0)
    return _pv(p, v, q.dtype)


def attention_safe(q, k, v, *, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Max-subtracted softmax attention, rows with no visible column 0."""
    s = _scores(q, k, causal, _scale(q, sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * (m > 0.5 * DEFAULT_MASK_VALUE)
    d = e.sum(dim=-1, keepdim=True)
    return _pv(e / torch.where(d == 0.0, 1.0, d), v, q.dtype)


def attention_online(q, k, v, *, causal: bool = False,
                     sm_scale: Optional[float] = None,
                     block_kv: int = 128) -> torch.Tensor:
    """One-pass online softmax: the whole q at once, KV streamed in blocks
    (the FA2 reference with one q block)."""
    return flash_attention_v2_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                  block_q=q.shape[-2], block_kv=block_kv)


def _kv_blocks(k, v, block_kv: int):
    """Yields (j, k block, v block) in f32, the last one zero-padded to
    block_kv rows."""
    kv_len = k.shape[-2]
    for j in range(-(-kv_len // block_kv)):
        kj = k[..., j * block_kv:(j + 1) * block_kv, :].float()
        vj = v[..., j * block_kv:(j + 1) * block_kv, :].float()
        pad = block_kv - kj.shape[-2]
        if pad:
            kj = torch.nn.functional.pad(kj, (0, 0, 0, pad))
            vj = torch.nn.functional.pad(vj, (0, 0, 0, pad))
        yield j, kj, vj


def _valid(rows: torch.Tensor, j: int, block_kv: int, kv_len: int,
           causal: bool) -> torch.Tensor:
    """Columns of kv block j that rows at positions `rows` (.., 1) see."""
    cols = j * block_kv + torch.arange(block_kv, device=rows.device)
    valid = cols < kv_len
    if causal:
        valid = valid & (cols <= rows)
    return valid


def _online_step(s, m_prev, l_prev):
    """One online-softmax update: (p, alpha, m_new, l_new)."""
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    # row-empty guard: a row that has seen only masked columns keeps m at
    # the mask floor, where exp(s - m) would be 1 per column
    p = torch.exp(s - m_new) * (m_new > 0.5 * DEFAULT_MASK_VALUE)
    alpha = torch.exp(m_prev - m_new)
    return p, alpha, m_new, alpha * l_prev + p.sum(dim=-1, keepdim=True)


def flash_attention_v1_ref(q, k, v, *, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           block_q: int = 128,
                           block_kv: int = 128) -> torch.Tensor:
    """FA1 loop order: KV outer; every row's (m, l, o) is carried across
    the whole sweep and o is renormalized on every step. block_q is the
    JAX signature's and, as there, unused."""
    sm_scale = _scale(q, sm_scale)
    q_len, d = q.shape[-2:]
    kv_len = k.shape[-2]
    lead = q.shape[:-2]
    qf = q.float() * sm_scale
    rows = torch.arange(q_len, device=q.device)[:, None] + (kv_len - q_len)
    m = torch.full((*lead, q_len, 1), -math.inf, device=q.device)
    l = torch.zeros((*lead, q_len, 1), device=q.device)
    o = torch.zeros((*lead, q_len, d), device=q.device)
    for j, kj, vj in _kv_blocks(k, v, block_kv):
        s = torch.where(_valid(rows, j, block_kv, kv_len, causal),
                        torch.matmul(qf, kj.transpose(-1, -2)),
                        DEFAULT_MASK_VALUE)
        p, alpha, m_new, l_new = _online_step(s, m, l)
        l_safe = torch.where(l_new == 0.0, 1.0, l_new)
        o = (l * alpha * o + torch.matmul(p, vj)) / l_safe
        m, l = m_new, l_new
    return o.to(q.dtype)


def flash_attention_v2_ref(q, k, v, *, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           block_q: int = 128, block_kv: int = 128,
                           return_lse: bool = False):
    """FA2 loop order: per q block an online softmax over KV blocks with
    unnormalized (m, l, acc) in f32 and one division in the epilogue. The
    q blocks are one batch dim here (JAX vmaps them). With return_lse also
    the natural-log LSE m + log(l) (..., q_len) in f32."""
    sm_scale = _scale(q, sm_scale)
    q_len, d = q.shape[-2:]
    kv_len = k.shape[-2]
    lead = q.shape[:-2]
    block_q = min(block_q, max(q_len, 1))
    n_q = -(-q_len // block_q)
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, n_q * block_q - q_len))
    qb = (qf * sm_scale).reshape(*lead, n_q, block_q, d)
    rows = (torch.arange(n_q * block_q, device=q.device)
            + (kv_len - q_len)).reshape(n_q, block_q, 1)
    m = torch.full((*lead, n_q, block_q, 1), -math.inf, device=q.device)
    l = torch.zeros((*lead, n_q, block_q, 1), device=q.device)
    acc = torch.zeros((*lead, n_q, block_q, d), device=q.device)
    for j, kj, vj in _kv_blocks(k, v, block_kv):
        kj, vj = kj.unsqueeze(-3), vj.unsqueeze(-3)
        s = torch.where(_valid(rows, j, block_kv, kv_len, causal),
                        torch.matmul(qb, kj.transpose(-1, -2)),
                        DEFAULT_MASK_VALUE)
        p, alpha, m, l = _online_step(s, m, l)
        acc = alpha * acc + torch.matmul(p, vj)
    # epilogue: one division; the empty-row guard of the cutlass kernel
    l_safe = torch.where((l == 0.0) | torch.isnan(l), 1.0, l)
    o = (acc / l_safe).reshape(*lead, n_q * block_q, d)[..., :q_len, :]
    o = o.to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(l_safe)).reshape(*lead, n_q * block_q)[..., :q_len]
    return o, lse


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, sm_scale: Optional[float] = None,
                  impl=attention_naive, return_lse: bool = False,
                  **impl_kwargs):
    """Multi-head (and GQA) attention over (batch, heads, seq, d) through
    one rung of the ladder (default the naive one). q heads must be a
    multiple of kv heads; each group of q heads reads its kv head. With
    return_lse (the FA2 rung) also the LSE (batch, heads, q_len)."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    if return_lse:
        impl_kwargs["return_lse"] = True
    return impl(q, k, v, causal=causal, sm_scale=sm_scale, **impl_kwargs)
