"""Rank functions of the sharded-serving tests, run by parallel/world.py.

One world of 8 gloo ranks on the CPU runs every case of
tests/test_torch_serve_sharded.py once. Every rank builds the same
meshes in the same order (a DeviceMesh makes its process groups with
every rank of the world): the (4, 2), (1, 8) and (2, 4) meshes over the
whole world, two (2, 2) meshes over ranks 0-3 and 4-7, four (1, 2)
meshes over the pairs and a (1, 1) mesh of rank 0. A job names the mesh
it runs on; the ranks of that mesh run it and the others skip it, so the
small meshes run side by side. This module imports torch, numpy and the
port only (the ranks never import JAX).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.models.engine import Request
from tiny_flash_attention_tpu_torch.parallel import comm
from tiny_flash_attention_tpu_torch.parallel.serve import (
    ShardedInferenceEngine, make_sharded_decode_loop)
from tiny_flash_attention_tpu_torch.parallel.sharded import make_mesh
from tiny_flash_attention_tpu_torch.parallel.train import (
    _local_cfg, shard_params, spmd_forward)

NAMES = ("data", "model")


def _meshes(device) -> dict:
    def sub(first, shape):
        n = shape[0] * shape[1]
        return DeviceMesh(device.type, torch.arange(first, first + n)
                          .reshape(shape), mesh_dim_names=NAMES)

    meshes = {"world": make_mesh(8, 4, 2, device=device.type),
              "line": sub(0, (1, 8)), "wide": sub(0, (2, 4)),
              "one": sub(0, (1, 1))}
    meshes.update({f"quad{i}": sub(4 * i, (2, 2)) for i in range(2)})
    meshes.update({f"pair{i}": sub(2 * i, (1, 2)) for i in range(4)})
    return meshes


def _on(mesh: DeviceMesh) -> bool:
    return dist.get_rank() in mesh.mesh.flatten().tolist()


def decode_loop_case(mesh, device, cfg, params, pages, tokens, positions,
                     table, temps, seed, *, fmt, n_steps, greedy):
    """make_sharded_decode_loop on this rank's shard: returns (sampled,
    this rank's local pages)."""
    model = mesh.get_local_rank("model")
    hkv = cfg.n_kv_heads // mesh.size(1)
    local = [p[model * hkv:(model + 1) * hkv].clone() for p in pages]
    loop = make_sharded_decode_loop(cfg, mesh, page_size=128, fmt=fmt,
                                    n_steps=n_steps, greedy=greedy,
                                    device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out, sampled = loop(shard_params(params, mesh, cfg), local, tokens,
                        positions, table, temps, gen)
    assert out is local
    return sampled, out


def engine_case(mesh, device, cfg, params, prompts, *, data_axis,
                temperature, max_new, chunk, **kw):
    """ShardedInferenceEngine.generate: (tokens, n_groups, the free list,
    the page tensors' shape)."""
    eng = ShardedInferenceEngine(cfg, params, mesh, data_axis=data_axis,
                                 device=device, **kw)
    got = eng.generate(prompts, max_new_tokens=max_new,
                       temperature=temperature, chunk=chunk)
    return (got, eng.cache.n_groups, sorted(eng.cache.free_pages),
            tuple(eng.cache.pages[0].shape))


def ragged_engine_case(mesh, device, cfg, params, prompts, *, mode,
                       data_axis, max_new, **kw):
    """ShardedInferenceEngine admitting `prompts` packed ("packed-page",
    "packed-pow2") or jagged, then max_new - 1 decode steps: the greedy
    tokens, the page table and this rank's pages after the admission, the
    slots and n_groups."""
    eng = ShardedInferenceEngine(cfg, params, mesh, data_axis=data_axis,
                                 device=device, **kw)
    reqs = [Request(list(p), max_new) for p in prompts]
    if mode == "jagged":
        eng.add_requests_jagged(reqs)
    else:
        eng.add_requests_packed(reqs, pack_bucket=mode.split("-")[1])
    table = torch.from_numpy(eng.cache.page_table.copy())
    pages = [p.clone() for p in eng.cache.pages]
    eng.steps(max_new - 1)
    return {"tokens": [r.generated for r in reqs], "table": table,
            "pages": pages, "slots": [r.slot for r in reqs],
            "n_groups": eng.cache.n_groups,
            "model": mesh.get_local_rank("model"),
            "group": mesh.get_local_rank("data")}


def spmd_case(mesh, device, cfg, params, tokens):
    """spmd_forward on this rank's data rows of `tokens`."""
    b = tokens.shape[0] // mesh.size(0)
    g = mesh.get_local_rank("data")
    return spmd_forward(_local_cfg(cfg, mesh.size(1)),
                        shard_params(params, mesh, cfg),
                        tokens[g * b:(g + 1) * b], mesh.get_group("model"))


def shards_case(mesh, device, cfg, params, bad_cfg):
    """This rank's shard_params, and the ValueError of a head count that
    does not split over the model axis."""
    local = shard_params(params, mesh, cfg)
    try:
        shard_params(params, mesh, bad_cfg)
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    return {"local": local, "refused": refused,
            "model": mesh.get_local_rank("model")}


def all_reduce_case(mesh, device, x):
    """x + rank through comm.all_reduce over the model axis (2 ranks), the
    data axis (4) and the whole world (8): each result's bits, and x left
    as it was; and the gradient of sum(all_reduce(x + rank) * w) over the
    model axis, w the same on every rank: its bits, and whether it is w
    (the identity backward)."""
    mine = x + dist.get_rank()
    keep = mine.clone()
    out = [comm.all_reduce(mine, mesh.get_group(name))
           for name in ("model", "data")]
    out.append(comm.all_reduce(mine, dist.group.WORLD))
    assert torch.equal(mine, keep)
    leaf = mine.clone().requires_grad_()
    w = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
    (comm.all_reduce(leaf, mesh.get_group("model")) * w).sum().backward()
    return {"sums": [o.view(torch.int32) for o in out],
            "grad": leaf.grad.view(torch.int32),
            "grad_is_identity": torch.equal(leaf.grad, w)}


def refusals_case(mesh, device, cfg, params):
    """The sharded engine's refusals: quantized weights (ValueError); and
    the loop and the engine without device="cpu": the card, which is
    absent here (RuntimeError) or not of the CPU mesh's type
    (ValueError)."""
    geom = dict(num_pages=8, page_size=128, max_seqs=2, pages_per_seq=2)
    refused = {}
    for name, make in (
            ("loop on the card", lambda: make_sharded_decode_loop(
                cfg, mesh, page_size=128, n_steps=1)),
            ("engine on the card", lambda: ShardedInferenceEngine(
                cfg, params, mesh, **geom))):
        try:
            make()
        except (RuntimeError, ValueError) as e:
            refused[name] = str(e)
    try:
        ShardedInferenceEngine(cfg, T.quantize_params(params), mesh,
                               device=device, **geom)
    except ValueError as e:
        refused["quantized"] = str(e)
    return refused


def run_jobs(rank, device, jobs):
    """jobs: [(name, mesh name, case function name, args, kwargs)]; returns
    {name: result} of the jobs whose mesh holds this rank."""
    meshes = _meshes(device)
    out = {}
    for name, mesh_name, fn, args, kwargs in jobs:
        mesh = meshes[mesh_name]
        if _on(mesh):
            out[name] = globals()[fn](mesh, device, *args, **kwargs)
    return out


def card_world_of_one(rank, device, fields, seed, prompts, fmt,
                      mode="batched"):
    """On the card, a (1, 1) mesh over a world of 1 on NCCL: the sharded
    engine and the single-card engine from the same weights, admitting
    batched (generate), packed ("packed-page", "packed-pow2") or jagged,
    generate the same greedy tokens and end with the same page bits."""
    from tiny_flash_attention_tpu_torch.models.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = T.ModelConfig(**fields)
    params = T.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(seed), device=device)
    geom = dict(num_pages=24, page_size=128, max_seqs=4, pages_per_seq=4,
                kv_format=fmt, device=device)
    mesh = make_mesh(1, 1, 1, device=device.type)
    engines = [ShardedInferenceEngine(cfg, params, mesh, **geom),
               InferenceEngine(cfg, params, **geom)]
    if mode == "batched":
        tokens = [e.generate(prompts, max_new_tokens=40, chunk=16)
                  for e in engines]
    else:
        tokens = []
        for e in engines:
            reqs = [Request(list(p), 40) for p in prompts]
            if mode == "jagged":
                e.add_requests_jagged(reqs)
            else:
                e.add_requests_packed(reqs, pack_bucket=mode.split("-")[1])
            e.steps(39)
            tokens.append([r.generated for r in reqs])
    same_pages = all(torch.equal(a, b) for a, b in zip(
        engines[0].cache.pages, engines[1].cache.pages))
    return {"tokens": tokens, "same_pages": same_pages}
