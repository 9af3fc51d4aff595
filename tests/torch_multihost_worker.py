"""One process of the multi-host test (tests/test_torch_multihost.py).

    python tests/torch_multihost_worker.py INPUTS OUT_DIR

with MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK set: the world is
configured by the environment alone, through `initialize_multihost`, and
stands for two hosts of two ranks (`make_hybrid_mesh(num_slices=2)`). It
checks what benchmarks/multiprocess_smoke.py checks: the sharded train
step with 'data' across the hosts and 'model' within them (3 SGD steps),
ring attention with its context axis across the hosts, and the sharded
decode loop with its data groups across the hosts (greedy and sampled).
INPUTS is a torch.save of the weights and inputs, made by the test; the
rank's results go to OUT_DIR/rank<r>.pt. Imports torch and the port only.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.ops.reference import mha_reference
from tiny_flash_attention_tpu_torch.parallel.multihost import (
    initialize_multihost, make_hybrid_mesh)
from tiny_flash_attention_tpu_torch.parallel.ring import (
    ring_attention_sharded)
from tiny_flash_attention_tpu_torch.parallel.serve import (
    make_sharded_decode_loop)
from tiny_flash_attention_tpu_torch.parallel.train import (
    make_train_step, shard_params)

HOSTS = 2
STEPS = 3
SERVE_STEPS = 6
INIT_TIMEOUT_S = 60


def train_losses(mesh, inp) -> list:
    cfg = T.ModelConfig(**inp["train_cfg"], dtype=torch.float32)
    step, init = make_train_step(
        cfg, mesh, optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2),
        device="cpu")
    params, opt = init(inp["train_params"])
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, inp["train_tokens"])
        losses.append(float(loss))
    return losses


def ring_output(inp) -> tuple:
    """Ring attention with 'ctx' across the hosts and 'data' within:
    (the global output, its max abs error against mha_reference)."""
    mesh = make_hybrid_mesh(ici_axes=("data",), ici_shape=(2,),
                            dcn_axis="ctx", num_slices=HOSTS,
                            axis_order=("data", "ctx"), device="cpu")
    q, k, v = inp["ring_qkv"]
    out = ring_attention_sharded(mesh, causal=True, ctx_axis="ctx")(q, k, v)
    err = float((out - mha_reference(q, k, v, causal=True)).abs().max())
    return out, err


def serve_tokens(mesh, inp) -> dict:
    """The sharded decode loop, data groups across the hosts: each rank
    holds its kv heads of its group's block of pages."""
    cfg = T.ModelConfig(**inp["serve_cfg"], dtype=torch.float32)
    tp, dp = mesh.size(1), mesh.size(0)
    m, g = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    hkv = cfg.n_kv_heads // tp
    params = shard_params(inp["serve_params"], mesh, cfg)
    out = {}
    for greedy in (True, False):
        pages = []
        for p in inp["pages"]:
            per = p.shape[1] // dp
            pages.append(p[m * hkv:(m + 1) * hkv, g * per:(g + 1) * per]
                         .clone())
        loop = make_sharded_decode_loop(
            cfg, mesh, page_size=128, fmt="bf16", n_steps=SERVE_STEPS,
            greedy=greedy, data_axis="data", device="cpu")
        temps = inp["temps"] * (0.0 if greedy else 1.0)
        gen = torch.Generator().manual_seed(inp["seed"])
        _, sampled = loop(params, pages, inp["tokens"], inp["positions"],
                          inp["table"], temps, gen)
        out["greedy" if greedy else "sampled"] = sampled
    return out


def main(inputs: str, out_dir: str) -> None:
    initialize_multihost(timeout_s=INIT_TIMEOUT_S, device="cpu")
    try:
        rank = dist.get_rank()
        inp = torch.load(inputs, weights_only=True)
        mesh = make_hybrid_mesh(ici_axes=("model",), ici_shape=(2,),
                                num_slices=HOSTS, device="cpu")
        sizes = {name: mesh.size(i)
                 for i, name in enumerate(mesh.mesh_dim_names)}
        losses = train_losses(mesh, inp)
        ring, ring_err = ring_output(inp)
        torch.save({"world": dist.get_world_size(), "sizes": sizes,
                    "data": mesh.get_local_rank("data"), "losses": losses,
                    "ring": ring, "ring_err": ring_err,
                    "serve": serve_tokens(mesh, inp)},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
