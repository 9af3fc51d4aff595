"""Single-card train step and checkpoints of the train state.

Counterpart of tiny_flash_attention_tpu/parallel/train.py::make_train_step
(:87-137) and save/restore_train_state (:140-176), on one card. The JAX step
is `jax.value_and_grad(T.loss_fn)` and an optax update, jitted with the
params and the optimizer state donated (`donate_argnums=(0, 1)`). Here the
step is eager PyTorch: `loss.backward()` through the model, whose attention
backward is ops/flash_bwd.py (csrc/flash_bwd.cu on the card), then a
`torch.optim` optimizer that updates the param leaves in place. That
in-place update is the port's counterpart of the donation: the params and
the optimizer state are not copied from step to step. Checkpoints use
torch.save and torch.load; orbax has no counterpart here.

The serving half of the sharded layer is here too (:37-65, :182-217):
`param_specs` (which dimension of each leaf is cut over the model axis:
megatron tensor parallelism, GQA co-location), `shard_params` (this rank's
local tensors), `_local_cfg` and `spmd_forward` (the inference forward on
local head shards, with an all-reduce over the model axis after wo and
after w_down, parallel/comm.py). parallel/serve.py runs the sharded
engine on them. The sharded train step (`sharded_attention`,
`make_train_step` on a mesh) is still to port.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.models.inference import _prefill
from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor
from tiny_flash_attention_tpu_torch.parallel import comm
from tiny_flash_attention_tpu_torch.utils.device import resolve_device


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The param tensors in a fixed order: the optimizer's state follows it,
    so a checkpoint restores into any params of the same config."""
    return [params["embed"],
            *(layer[name] for layer in params["layers"]
              for name in sorted(layer)),
            params["final_norm"], params["lm_head"]]


def _map_params(fn, params: dict) -> dict:
    return {"embed": fn(params["embed"]),
            "layers": [{name: fn(t) for name, t in layer.items()}
                       for layer in params["layers"]],
            "final_norm": fn(params["final_norm"]),
            "lm_head": fn(params["lm_head"])}


def make_train_step(
        cfg: T.ModelConfig, *, learning_rate: float = 1e-3,
        optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
        device=None):
    """Returns (train_step, init_state).

    init_state(params) -> (params, opt_state): copies the params onto
    `device` (default: the card) as leaves that require grad and builds the
    optimizer over them; the caller's tensors are left as they are.
    `optimizer` takes the list of param leaves and returns a
    torch.optim.Optimizer (e.g. `lambda ps: torch.optim.SGD(ps, lr=1e-2)`).
    The default is `optax.adamw(learning_rate)` as a torch AdamW: b1 0.9,
    b2 0.999, eps 1e-8 and weight decay 1e-4 (optax's default, not torch's
    1e-2) on every leaf. torch decays the param before the Adam step and
    optax adds the decay to the update; both give p (1 - lr wd) - lr adam.

    train_step(params, opt_state, tokens) -> (params, opt_state, loss):
    tokens (batch, seq) int; the loss is the step's mean next-token NLL
    before its update, a 0-dim f32 tensor on the device (reading it syncs
    with the host; the step itself does not). params and opt_state come
    back updated in place.
    """
    device = resolve_device(device)
    if optimizer is None:
        def optimizer(leaves: list) -> torch.optim.Optimizer:
            return torch.optim.AdamW(leaves, lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=1e-4)

    def init_state(params: dict):
        params = _map_params(
            lambda t: t.detach().to(device, copy=True).requires_grad_(True),
            params)
        return params, optimizer(param_leaves(params))

    def train_step(params: dict, opt_state: torch.optim.Optimizer, tokens):
        tokens = torch.as_tensor(tokens, device=device)
        opt_state.zero_grad(set_to_none=True)
        loss = T.loss_fn(cfg, params, tokens)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step, init_state


def save_train_state(path: str, params: dict,
                     opt_state: torch.optim.Optimizer, *, step: int = 0):
    """Checkpoints the train state: the params, the optimizer's state_dict
    and the step. `path` is created; the checkpoint lands at
    `path`/state.pt."""
    os.makedirs(path, exist_ok=True)
    torch.save({"params": _map_params(torch.Tensor.detach, params),
                "opt_state": opt_state.state_dict(), "step": int(step)},
               os.path.join(path, "state.pt"))


def restore_train_state(path: str, params: dict,
                        opt_state: torch.optim.Optimizer):
    """Restores a checkpoint of save_train_state into `params` and
    `opt_state` in place (e.g. those of a fresh init_state, which give the
    structure, shapes and dtypes), so the optimizer stays bound to the
    param leaves. Returns (params, opt_state, step)."""
    leaves = param_leaves(params)
    state = torch.load(os.path.join(path, "state.pt"),
                       map_location=leaves[0].device, weights_only=True)
    saved = param_leaves(state["params"])
    if [t.shape for t in saved] != [t.shape for t in leaves]:
        raise ValueError("the checkpoint's params do not match these params")
    with torch.no_grad():
        for dst, src in zip(leaves, saved):
            dst.copy_(src)
    opt_state.load_state_dict(state["opt_state"])
    return params, opt_state, int(state["step"])


# --- tensor parallelism for inference (the serving path) ---------------------

# the dimension of each layer leaf cut over the model axis (None: replicated)
_LAYER_SPEC = {"attn_norm": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
               "mlp_norm": None, "w_gate": 1, "w_up": 1, "w_down": 0}


def param_specs(cfg: T.ModelConfig) -> dict:
    """For each leaf of init_params' tree, the dimension cut into
    contiguous blocks over the model axis, or None where it is replicated
    (JAX's PartitionSpecs, train.py:37-56, on the port's list of layers):
    the columns of wq, wk, wv, w_gate and w_up, the rows of wo and w_down;
    rank r of tp then holds q heads [r hq/tp, (r+1) hq/tp) and kv heads
    [r hkv/tp, (r+1) hkv/tp), each q head beside its kv head."""
    return {"embed": None, "layers": [dict(_LAYER_SPEC)
                                      for _ in range(cfg.n_layers)],
            "final_norm": None, "lm_head": None}


def _axis(mesh: DeviceMesh, name: str) -> tuple[int, int]:
    """(size, this rank's index) of a mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(name)), \
        mesh.get_local_rank(name)


def _local_cfg(cfg: T.ModelConfig, tp: int) -> T.ModelConfig:
    """The config of one rank's head shard (JAX asserts, :182-187)."""
    if cfg.n_q_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"heads ({cfg.n_q_heads}q/{cfg.n_kv_heads}kv) not "
                         f"divisible by tp={tp}")
    return dataclasses.replace(cfg, n_q_heads=cfg.n_q_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp)


def shard_params(params: dict, mesh: DeviceMesh, cfg: T.ModelConfig, *,
                 model_axis: str = "model") -> dict:
    """This rank's local params: each cut leaf's block along its
    param_specs dimension, a fresh contiguous tensor; the replicated leaves
    are the caller's tensors. Quantized weights raise ValueError (JAX's
    param_specs tree does not cover them either), as do heads or d_ff that
    do not split over the model axis."""
    tp, r = _axis(mesh, model_axis)
    _local_cfg(cfg, tp)
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by tp={tp}")

    def cut(t, dim):
        if isinstance(t, QuantizedTensor):
            raise ValueError("the sharded path takes float weights, not "
                             "quantized ones")
        if dim is None:
            return t
        size = t.shape[dim] // tp
        return t.narrow(dim, r * size, size).clone(
            memory_format=torch.contiguous_format)

    specs = param_specs(cfg)
    return {"embed": cut(params["embed"], None),
            "layers": [{k: cut(t, spec[k]) for k, t in layer.items()}
                       for layer, spec in zip(params["layers"],
                                              specs["layers"])],
            "final_norm": cut(params["final_norm"], None),
            "lm_head": cut(params["lm_head"], None)}


def row_parallel_add(x: torch.Tensor, out: torch.Tensor, group) -> \
        torch.Tensor:
    """x + psum(out.astype(f32)).astype(x.dtype) (:205-214): a row-cut
    weight's partial product, already rounded to the model dtype, summed
    over the model axis in f32 and rounded again. At tp = 1 it is the
    single-card residual add, bit for bit."""
    return x + comm.all_reduce(out.float(), group).to(x.dtype)


def spmd_forward(cfg_local: T.ModelConfig, params: dict,
                 tokens: torch.Tensor, model_group) -> torch.Tensor:
    """The inference forward on this rank's head shard (:190-217):
    tokens (b, s) -> logits (b, s, vocab) f32, the same on every rank of
    `model_group` (the model axis's process group, `mesh.get_group(
    "model")`). cfg_local is `_local_cfg(cfg, tp)` and params this rank's
    `shard_params`; attention is B1 on the local heads. Forward only."""
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return _prefill(cfg_local, params, tokens, positions,
                    lambda q, k, v: T._attention(cfg_local, q, k, v,
                                                 causal=True),
                    functools.partial(row_parallel_add,
                                      group=model_group))[0]
