"""Rank functions of the sharded-train tests, run by parallel/world.py.

One world of 8 gloo ranks on the CPU runs every case of
tests/test_torch_train_sharded.py once. Every rank builds the (4, 2) and
(8, 1) (data, model) meshes over the whole world, in the same order (a
DeviceMesh makes its process groups with every rank), and runs every job
on the mesh it names. This module imports torch, numpy and the port only
(the ranks never import JAX).
"""

from __future__ import annotations

import os

import torch

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.parallel import comm
from tiny_flash_attention_tpu_torch.parallel.multihost import (
    initialize_multihost, make_hybrid_mesh)
from tiny_flash_attention_tpu_torch.parallel.sharded import make_mesh
from tiny_flash_attention_tpu_torch.parallel.train import (
    make_train_step, param_leaves, restore_train_state, save_train_state)

MESHES = {"4x2": (4, 2), "8x1": (8, 1)}


def _sgd(leaves):
    return torch.optim.SGD(leaves, lr=1e-2)


def _leaves(params) -> list:
    return [t.detach().clone() for t in param_leaves(params)]


def sgd_case(meshes, device, mesh, cfg, params, tokens):
    """One SGD(1e-2) step: the loss and this rank's leaves after it."""
    step, init = make_train_step(cfg, meshes[mesh], optimizer=_sgd,
                                 device=device)
    p, opt = init(params)
    p, opt, loss = step(p, opt, tokens)
    return {"loss": loss, "leaves": _leaves(p),
            "model": meshes[mesh].get_local_rank("model")}


def adamw_case(meshes, device, mesh, cfg, params, batches):
    """The default optimizer (AdamW) over the batches: the losses."""
    step, init = make_train_step(cfg, meshes[mesh], device=device)
    p, opt = init(params)
    losses = []
    for tokens in batches:
        p, opt, loss = step(p, opt, tokens)
        losses.append(loss)
    return losses


def checkpoint_case(meshes, device, cfg, params, fresh, batches, path):
    """Two AdamW steps on (4, 2), a checkpoint, the third step (the
    uninterrupted run); then fresh states on (4, 2) and on (8, 1), each
    restored from the checkpoint, and the third step again."""
    mesh = meshes["4x2"]
    step, init = make_train_step(cfg, mesh, device=device)
    p, opt = init(params)
    for tokens in batches[:2]:
        p, opt, _ = step(p, opt, tokens)
    save_train_state(path, p, opt, step=2, mesh=mesh)
    _, _, cont = step(p, opt, batches[2])
    out = {"cont": cont, "model": mesh.get_local_rank("model")}
    for name in ("4x2", "8x1"):
        step, init = make_train_step(cfg, meshes[name], device=device)
        p, opt = init(fresh)
        p, opt, at = restore_train_state(path, p, opt, meshes[name], cfg)
        restored = _leaves(p)
        _, _, loss = step(p, opt, batches[2])
        out[name] = {"step": at, "loss": loss, "restored": restored}
    return out


def hybrid_case(meshes, device):
    """initialize_multihost() with no coordinator configured (a no-op),
    then make_hybrid_mesh over the world of 8: its axis sizes, and a sum
    over 'model' of arange(8)'s blocks."""
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR"):
        os.environ.pop(name, None)
    initialize_multihost()
    mesh = make_hybrid_mesh(ici_axes=("model", "seq"), ici_shape=(4, 2),
                            device=device.type)
    sizes = {name: mesh.size(i) for i, name in
             enumerate(mesh.mesh_dim_names)}
    group = mesh.get_group("model")
    block = comm.take_shard(torch.arange(8.0), group, 0)
    return {"sizes": sizes, "total": comm.all_reduce(block.sum(), group)}


def refusals_case(meshes, device, cfg, params, bad_cfg):
    """The ValueErrors of the sharded step: a batch that does not split
    over 'data', quantized weights, heads that do not split over
    'model'."""
    mesh = meshes["4x2"]
    step, init = make_train_step(cfg, mesh, optimizer=_sgd, device=device)
    p, opt = init(params)
    attempts = {
        "batch": lambda: step(p, opt, torch.zeros((6, 16), dtype=torch.int64)),
        "quantized": lambda: init(T.quantize_params(params)),
        "heads": lambda: make_train_step(bad_cfg, mesh, device=device),
    }
    refused = {}
    for name, attempt in attempts.items():
        try:
            attempt()
        except ValueError as e:
            refused[name] = str(e)
    return refused


def run_jobs(rank, device, jobs):
    """jobs: [(name, case function name, args)]; every rank runs every job
    on the meshes of MESHES; returns {name: result}."""
    meshes = {name: make_mesh(8, *shape, device=device.type)
              for name, shape in MESHES.items()}
    return {name: globals()[fn](meshes, device, *args)
            for name, fn, args in jobs}
