"""Context parallelism: ring attention, zigzag ring, Ulysses and all-gather.

Counterpart of tiny_flash_attention_tpu/parallel/ring.py on torch.distributed.
Each rank holds one sequence shard; the modes run over one axis of a
DeviceMesh (parallel/sharded.py):

  * ring attention (make_ring_attention): K/V shards rotate around the ring
    (parallel/comm.py::Rotation, JAX's `ppermute`) while each rank runs
    the flash forward on the block in front of it; the partial (out, lse)
    pairs merge with the cross-block log-sum-exp combine (`_merge`).
    Causal: earlier-source blocks attend fully, the diagonal block
    causally, later blocks are skipped (no launch).
  * zigzag ring (make_zigzag_ring_attention): stripes (i, 2n-1-i) on rank
    i, so every rank does the same causal work at every step.
  * Ulysses (make_ulysses_attention): all-to-all heads <-> sequence, causal
    flash over the whole sequence for a head subset, and back.
  * all-gather (make_allgather_attention): gather K/V, local non-causal
    flash.

Every local flash call is ops/flash.py::flash_attention, the bf16/f32
forward kernel (csrc/flash_fwd.cu) on the card and its plain version on the
CPU. The ring and the zigzag ring ask for the LSE, which is forward-only on
the card as in JAX (`return_lse=True` has no VJP there): a backward through
them raises on CUDA; on the CPU it runs through the plain version and the
rotations' transposes. Each entry takes JAX's `config`, the port's
FlashConfig (ops/configs.py), and threads it into every local flash call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
from tiny_flash_attention_tpu_torch.parallel import comm
from tiny_flash_attention_tpu_torch.parallel.sharded import shard_map


def _merge(o, lse, o_i, lse_i):
    """Cross-block online-softmax combine of normalized partials (f32)."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_i - lse_new)[..., None]
    # exp(-inf - -inf) -> nan guard for rows nobody has touched yet
    w_old = torch.where(torch.isnan(w_old), 0.0, w_old)
    w_new = torch.where(torch.isnan(w_new), 0.0, w_new)
    return o * w_old + o_i.to(o.dtype) * w_new, lse_new


class _KeepRotations(torch.autograd.Function):
    """Returns o; its backward hands zero gradients to the last blocks a
    rank received. JAX's SPMD program runs every ppermute's transpose on
    every device; here a rotation's backward runs only where a gradient
    reaches it, and a rank whose last step is skipped (causal) would leave
    its neighbours waiting in theirs."""

    @staticmethod
    def forward(ctx, o, kb, vb):
        ctx.blocks = [(t.shape, t.dtype, t.device) for t in (kb, vb)]
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return g, *(torch.zeros(s, dtype=d, device=dev)
                    for s, d, dev in ctx.blocks)


def make_ring_attention(mesh, *, axis_name: str = "ctx", causal: bool = True,
                        sm_scale: Optional[float] = None,
                        config: Optional[FlashConfig] = None):
    """Returns ring(q, k, v): all inputs are LOCAL sequence shards
    (b, h, s_local, d) of this rank; the output is this rank's shard of the
    exact global attention.

    Each step posts the next block's rotation before its flash call, so the
    transfer can run under the compute, and rotates the block it received,
    never its own output. With contiguous shards causal rank i computes i+1
    of the n blocks; make_zigzag_ring_attention balances them.
    """
    n = mesh.get_group(axis_name).size()

    def ring(q, k, v):
        group = mesh.get_group(axis_name)
        idx = mesh.get_local_rank(axis_name)
        lse = torch.full(q.shape[:3], -math.inf, dtype=torch.float32,
                         device=q.device)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for step in range(n):
            pending = (comm.Rotation((kb, vb), group)
                       if step < n - 1 else None)
            src = (idx - step) % n  # ring shard this kb/vb originated from
            if not causal or src < idx:
                part = flash_attention(q, kb, vb, causal=False,
                                       sm_scale=sm_scale, config=config,
                                       return_lse=True)
            elif src == idx:
                part = flash_attention(q, kb, vb, causal=True,
                                       sm_scale=sm_scale, config=config,
                                       return_lse=True)
            else:
                part = None  # a later block: skipped, merging it adds 0
            if part is not None:
                o, lse = _merge(o, lse, *part)
            if pending is not None:
                kb, vb = pending.wait()
        if n > 1:
            o = _KeepRotations.apply(o, kb, vb)
        return o.to(q.dtype)

    return ring


def ring_attention_sharded(mesh, *, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           data_axis: str = "data", ctx_axis: str = "model",
                           config: Optional[FlashConfig] = None):
    """q/k/v (b, h, S, d), the global tensors on every rank; the batch cut
    over data_axis and S over ctx_axis; returns the global output."""
    ring = make_ring_attention(mesh, axis_name=ctx_axis, causal=causal,
                               sm_scale=sm_scale, config=config)
    return shard_map(ring, mesh, (data_axis, None, ctx_axis, None))


# --- zigzag (balanced causal) ring ------------------------------------------
# The sequence is cut into 2n stripes and rank i holds stripes (i, 2n-1-i),
# one early and one late, so every rank does about 2 stripe-units of work at
# every step (the derivation: the JAX module's zigzag section). Each branch
# is one or two contiguous flash calls: "full kv then diagonal kv" is the
# decode offset of causal(q_late, concat(c, d)), L rows against 2L.


def zigzag_permutation(seq_len: int, n: int) -> np.ndarray:
    """Global position order such that contiguous shard i of the permuted
    sequence holds stripes (i, 2n-1-i) of the original."""
    if seq_len % (2 * n):
        raise ValueError(f"seq_len {seq_len} does not cut into {2 * n} "
                         f"stripes")
    stripe = seq_len // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * stripe, (i + 1) * stripe))
        order.extend(range((2 * n - 1 - i) * stripe, (2 * n - i) * stripe))
    return np.asarray(order, np.int64)


def zigzag_permute(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Reorders a sequence axis into zigzag shard order (one gather, paid
    once per sequence)."""
    perm = torch.from_numpy(zigzag_permutation(x.shape[axis], n))
    return x.index_select(axis, perm.to(x.device))


def zigzag_unpermute(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Inverse of zigzag_permute."""
    perm = zigzag_permutation(x.shape[axis], n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return x.index_select(axis, torch.from_numpy(inv).to(x.device))


def make_zigzag_ring_attention(mesh, *, axis_name: str = "ctx",
                               sm_scale: Optional[float] = None,
                               config: Optional[FlashConfig] = None):
    """Returns ring(q, k, v) over ZIGZAG-placed shards: local tensors are
    (b, h, 2L, d) = stripes (idx, 2n-1-idx) concatenated (zigzag_permute).
    The output is this rank's shard of exact global causal attention, in
    the same zigzag layout. Rank i makes n + 1 flash launches."""
    n = mesh.get_group(axis_name).size()

    def ring(q, k, v):
        if n == 1:
            return flash_attention(q, k, v, causal=True, sm_scale=sm_scale,
                                   config=config)
        group = mesh.get_group(axis_name)
        idx = mesh.get_local_rank(axis_name)
        L = q.shape[2] // 2
        q_a, q_b = q[:, :, :L], q[:, :, L:]

        def flash(qq, kk, vv, causal):
            return flash_attention(qq, kk, vv, causal=causal,
                                   sm_scale=sm_scale, config=config,
                                   return_lse=True)

        def before(kb, vb):       # src < idx: (a|c) + (b|c) full
            return flash(q, kb[:, :, :L], vb[:, :, :L], causal=False)

        def self_(kb, vb):        # diag(a|c) + causal(b, [c d])
            oa, la = flash(q_a, kb[:, :, :L], vb[:, :, :L], causal=True)
            ob, lb = flash(q_b, kb, vb, causal=True)  # c full, d diagonal
            return torch.cat([oa, ob], 2), torch.cat([la, lb], 2)

        def after(kb, vb):        # (b|c) + (b|d) full; a skips
            ob, lb = flash(q_b, kb, vb, causal=False)
            return (torch.cat([torch.zeros_like(ob), ob], 2),
                    torch.cat([torch.full_like(lb, -math.inf), lb], 2))

        lse = torch.full(q.shape[:3], -math.inf, dtype=torch.float32,
                         device=q.device)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for step in range(n):
            pending = (comm.Rotation((kb, vb), group)
                       if step < n - 1 else None)
            src = (idx - step) % n
            branch = self_ if src == idx else before if src < idx else after
            o, lse = _merge(o, lse, *branch(kb, vb))
            if pending is not None:
                kb, vb = pending.wait()
        return o.to(q.dtype)

    return ring


def zigzag_ring_attention_sharded(mesh, *, sm_scale: Optional[float] = None,
                                  data_axis: str = "data",
                                  ctx_axis: str = "model",
                                  config: Optional[FlashConfig] = None):
    """Balanced causal CP: q/k/v (b, h, S, d) ALREADY in zigzag order
    (zigzag_permute), the global tensors on every rank, S cut over
    ctx_axis; returns the global output in zigzag order."""
    ring = make_zigzag_ring_attention(mesh, axis_name=ctx_axis,
                                      sm_scale=sm_scale, config=config)
    return shard_map(ring, mesh, (data_axis, None, ctx_axis, None))


def make_ulysses_attention(mesh, *, axis_name: str = "ctx",
                           causal: bool = True,
                           sm_scale: Optional[float] = None,
                           config: Optional[FlashConfig] = None):
    """Returns ulysses(q, k, v): inputs are local sequence shards
    (b, h, s_local, d) whose q and kv heads both divide by the axis size
    (else the all-to-all raises); all-to-alls to (b, h/n, S, d), runs exact
    flash over the whole sequence, and transposes back."""
    n = mesh.get_group(axis_name).size()

    def ulysses(q, k, v):
        group = mesh.get_group(axis_name)

        def scatter_heads(x):     # (b, h, s_local, d) -> (b, h/n, S, d)
            return comm.all_to_all(x, group, split_axis=1, concat_axis=2)

        oh = flash_attention(scatter_heads(q), scatter_heads(k),
                             scatter_heads(v), causal=causal,
                             sm_scale=sm_scale, config=config)
        return comm.all_to_all(oh, group, split_axis=2, concat_axis=1)

    return ulysses


def ulysses_attention_sharded(mesh, *, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              data_axis: str = "data",
                              ctx_axis: str = "model",
                              config: Optional[FlashConfig] = None):
    """q/k/v (b, h, S, d), the global tensors on every rank, S cut over
    ctx_axis, heads divisible by its size; returns the global output."""
    ulysses = make_ulysses_attention(mesh, axis_name=ctx_axis, causal=causal,
                                     sm_scale=sm_scale, config=config)
    return shard_map(ulysses, mesh, (data_axis, None, ctx_axis, None))


def make_allgather_attention(mesh, *, axis_name: str = "ctx",
                             sm_scale: Optional[float] = None,
                             config: Optional[FlashConfig] = None):
    """Non-causal all-gather context parallelism: gather K/V, local flash."""
    def ag(q, k, v):
        group = mesh.get_group(axis_name)
        return flash_attention(q, comm.all_gather(k, group, 2),
                               comm.all_gather(v, group, 2), causal=False,
                               sm_scale=sm_scale, config=config)

    return ag
