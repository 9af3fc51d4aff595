"""Multi-card attention sharding: the mesh and head-parallel flash attention.

Counterpart of tiny_flash_attention_tpu/parallel/sharded.py. A (data, model)
mesh, here a `DeviceMesh` over the ranks of a torch.distributed world (one
process a rank, parallel/world.py; JAX's mesh is one process over its
devices): the batch is data-parallel and the attention heads are
tensor-parallel, with GQA co-location (each group of q heads lands on the
rank holding its kv head: no collective during attention). Sequence-parallel
attention lives in parallel/ring.py.

The functions that stand for `jax.jit(shard_map(f, in_specs, out_specs))`
take the global tensors on every rank, cut this rank's block by its mesh
coordinates (in_specs), run f on it and gather the blocks back (out_specs),
so every rank returns the same global tensor. `config` is JAX's
argument: the port's FlashConfig (ops/configs.py), passed to every local
flash call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
from tiny_flash_attention_tpu_torch.parallel import comm
from tiny_flash_attention_tpu_torch.utils.device import resolve_device


def mesh_shape(n_devices: int, data: Optional[int] = None,
               model: Optional[int] = None) -> tuple[int, int]:
    """(data, model) sizes of `make_mesh`, JAX's split: without sizes the
    model axis doubles while twice it stays within 2 * floor(sqrt(n)) and
    divides n, the rest is data; one size given, the other is n over it."""
    if model is None:
        if data is not None:
            model = n_devices // data
        else:
            model = 1
            while model * 2 <= math.isqrt(n_devices) * 2 and \
                    n_devices % (model * 2) == 0 and model * 2 <= n_devices:
                model *= 2
    if data is None:
        data = n_devices // model
    if data * model != n_devices:
        raise ValueError(f"data {data} x model {model} != {n_devices} devices")
    return data, model


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None, axis_names=("data", "model"), *,
              device=None) -> DeviceMesh:
    """A 2-D (data, model) DeviceMesh over the ranks of the current world,
    rank r at (r // model, r % model), as JAX reshapes its devices. The
    world must hold n_devices ranks (default: all of it). Its device type
    is `device`'s: the card unless the caller asks for the CPU."""
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                         f"{n_devices} ranks, not {world}")
    shape = mesh_shape(n_devices, data, model)
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=tuple(axis_names))


def shard_map(local_fn, mesh: DeviceMesh, spec: tuple):
    """f(q, k, v) on global tensors for a local function under one
    PartitionSpec for the three inputs and the output: `spec` names, for
    each tensor axis, the mesh axis it is cut over (or None)."""
    axes = [(i, name) for i, name in enumerate(spec) if name is not None]

    def run(q, k, v):
        shards = []
        for x in (q, k, v):
            for i, name in axes:
                x = comm.take_shard(x, mesh.get_group(name), i)
            shards.append(x)
        out = local_fn(*shards)
        for i, name in reversed(axes):
            out = comm.gather_shards(out, mesh.get_group(name), i)
        return out

    return run


def sharded_flash_attention(mesh: DeviceMesh, *, causal: bool = False,
                            sm_scale=None,
                            config: Optional[FlashConfig] = None,
                            data_axis: str = "data",
                            model_axis: str = "model"):
    """Head-parallel + data-parallel flash attention.

    Layout: batch on the data axis, q heads AND kv heads on the model axis
    (GQA co-location: q_heads % kv_heads == 0 and kv_heads % model == 0
    keeps each q-head group with its kv head: no collective during
    attention; heads that do not split raise). Takes and returns global
    (b, h, S, d) tensors on every rank.
    """
    def attn(q, k, v):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               config=config)

    return shard_map(attn, mesh, (data_axis, model_axis, None, None))
