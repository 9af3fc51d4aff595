"""Rank functions of the context-parallel tests, run by parallel/world.py.

Each runs on every rank of a spawned world, so it lives in a module that
imports torch, numpy and the port only (the ranks never import JAX). A
case is (name, mode, inputs, options): the global q, k, v as numpy arrays
(or torch tensors for bf16), the same on every rank; each rank returns
every case's global output, so a test can also check that the ranks agree.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from tiny_flash_attention_tpu_torch.parallel import comm, ring as R
from tiny_flash_attention_tpu_torch.parallel.sharded import (
    make_mesh, shard_map, sharded_flash_attention)


def _tensor(x, device, requires_grad=False):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
    return t.to(device).requires_grad_(requires_grad)


def _mesh(device, shape, names):
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def _local_fn(mode, mesh, opts):
    """The local function of a mode over the mesh's "ctx" axis."""
    if mode == "ring":
        return R.make_ring_attention(mesh, causal=opts.get("causal", True))
    if mode == "zigzag":
        return R.make_zigzag_ring_attention(mesh)
    if mode == "ulysses":
        return R.make_ulysses_attention(mesh,
                                        causal=opts.get("causal", True))
    if mode == "allgather":
        return R.make_allgather_attention(mesh)
    raise ValueError(mode)


def run_cases(rank, device, mesh_spec, cases):
    """Runs each case on a mesh of shape/names `mesh_spec`; the sequence is
    cut over "ctx" and, where the mesh has it, the heads over "head". With
    opts["grad"], returns (out, dq, dk, dv) of loss = sum(out ** 2)."""
    shape, names = mesh_spec
    mesh = _mesh(device, shape, names)
    spec = tuple("head" if (i == 1 and "head" in names) else
                 "ctx" if i == 2 else None for i in range(4))
    results = {}
    for name, mode, inputs, opts in cases:
        grad = opts.get("grad", False)
        q, k, v = (_tensor(x, device, grad) for x in inputs)
        fn = shard_map(_local_fn(mode, mesh, opts), mesh, spec)
        if mode == "zigzag":
            n = mesh.size(names.index("ctx"))
            out = R.zigzag_unpermute(fn(*(R.zigzag_permute(x, n)
                                          for x in (q, k, v))), n)
        else:
            out = fn(q, k, v)
        if grad:
            (out.float() ** 2).sum().backward()
            results[name] = [t.detach() for t in (out, q.grad, k.grad,
                                                   v.grad)]
        else:
            results[name] = out.detach()
    return results


def run_sharded_flash(rank, device, inputs, causal):
    """sharded_flash_attention on make_mesh(8, data=4, model=2), and
    make_mesh's default shape over the world."""
    mesh = make_mesh(8, data=4, model=2, device=device.type)
    q, k, v = (_tensor(x, device) for x in inputs)
    out = sharded_flash_attention(mesh, causal=causal)(q, k, v)
    default = make_mesh(device=device.type)
    return {"out": out, "mesh": list(mesh.shape),
            "default": list(default.shape)}


def config_entries(rank, device, inputs, config):
    """Each context-parallel entry (ring causal and not, zigzag, Ulysses,
    all-gather) over a "ctx" axis of the whole world and
    sharded_flash_attention on a (1, world) mesh, each called without and
    with `config`: {name: (out without, out with)}."""
    n = dist.get_world_size()
    mesh = _mesh(device, (n,), ("ctx",))
    q, k, v = (_tensor(x, device) for x in inputs)
    spec = (None, None, "ctx", None)
    out = {}
    for name, make in (
            ("ring", lambda **kw: R.make_ring_attention(mesh, **kw)),
            ("ring non-causal", lambda **kw: R.make_ring_attention(
                mesh, causal=False, **kw)),
            ("ulysses", lambda **kw: R.make_ulysses_attention(mesh, **kw)),
            ("allgather", lambda **kw: R.make_allgather_attention(
                mesh, **kw))):
        out[name] = tuple(shard_map(make(**kw), mesh, spec)(q, k, v)
                          for kw in ({}, {"config": config}))
    zz = [R.zigzag_unpermute(shard_map(
        R.make_zigzag_ring_attention(mesh, **kw), mesh, spec)(
        *(R.zigzag_permute(x, n) for x in (q, k, v))), n)
        for kw in ({}, {"config": config})]
    out["zigzag"] = tuple(zz)
    grid = make_mesh(n, data=1, model=n, device=device.type)
    out["sharded"] = tuple(
        sharded_flash_attention(grid, causal=True, **kw)(q, k, v)
        for kw in ({}, {"config": config}))
    return out


def ring_events(rank, device, mesh_spec, inputs, causal):
    """The order of one ring call's rotations and flash calls on this rank,
    and whether every step sends the block it received (the input shard at
    step 0), never a flash output."""
    mesh = _mesh(device, *mesh_spec)
    events, sent_ok = [], []
    real_post, real_flash = comm.Rotation, R.flash_attention
    state = {"expect": None, "outputs": []}

    def post(tensors, group, shift=1):
        tensors = tuple(tensors)
        sent_ok.append(all(a is b for a, b in zip(tensors, state["expect"]))
                       and not any(t is o for t in tensors
                                   for o in state["outputs"]))
        events.append("post")
        pending = real_post(tensors, group, shift)
        wait = pending.wait

        def waited():
            got = wait()
            state["expect"] = got
            events.append("recv")
            return got

        pending.wait = waited
        return pending

    def flash(*args, **kwargs):
        out = real_flash(*args, **kwargs)
        state["outputs"].extend(out if isinstance(out, tuple) else [out])
        events.append("flash")
        return out

    q, k, v = (comm.take_shard(_tensor(x, device), mesh.get_group("ctx"), 2)
               for x in inputs)
    state["expect"] = (k, v)
    comm.Rotation, R.flash_attention = post, flash
    try:
        R.make_ring_attention(mesh, causal=causal)(q, k, v)
    finally:
        comm.Rotation, R.flash_attention = real_post, real_flash
    return {"events": events, "sent_received": sent_ok}


def run_jobs(rank, device, jobs):
    """Runs the named rank functions of this module in turn: one world for
    many cases."""
    return [globals()[name](rank, device, *args) for name, args in jobs]


def fail_on_rank(rank, device, bad):
    """Rank `bad` raises; the others return."""
    if rank == bad:
        raise ValueError(f"planted failure on rank {rank}")
    return rank


def unmatched_recv(rank, device):
    """Rank 0 waits for a message that rank 1 never sends."""
    if rank == 0:
        dist.recv(torch.empty(1, device=device), src=1)
    return rank
