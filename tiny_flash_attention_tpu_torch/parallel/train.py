"""The train step, on one card or on a (data, model) mesh, and checkpoints of
the train state.

Counterpart of tiny_flash_attention_tpu/parallel/train.py. The JAX step is
`jax.value_and_grad(T.loss_fn)` and an optax update, jitted with the params
and the optimizer state donated (`donate_argnums=(0, 1)`). Here the step is
eager PyTorch: `loss.backward()` through the model, whose attention
backward is ops/flash_bwd.py (csrc/flash_bwd.cu on the card), then a
`torch.optim` optimizer that updates the param leaves in place. That
in-place update is the port's counterpart of the donation: the params and
the optimizer state are not copied from step to step.

On a mesh (data x tensor parallel, :87-137) JAX partitions the
single-device loss with GSPMD, which inserts the megatron collectives and
differentiates through them, and runs the Pallas attention in a shard_map
island with batch on 'data' and heads on 'model' (`sharded_attention`).
Here every rank of a torch.distributed world runs the step on its shard:

  * MODEL axis: the rank's head block (`param_specs`, `shard_params`; GQA
    co-location, so attention makes no collective). Per layer, f
    (`comm.enter_model`) takes the normed input of the column-cut products
    (wq, wk, wv; w_gate, w_up) and g (`comm.all_reduce` in
    `row_parallel_add`) sums the row-cut products (wo, w_down). f's
    backward sums the partial gradient of the normed input over the axis
    and g's is the identity, so the replicated leaves (embed, the norms,
    lm_head) get their whole gradient on every rank, the same bits on
    each.
  * DATA axis: the rank's block of the global batch. After backward(), one
    all-reduce of a flat f32 buffer of every local gradient and the loss
    gives their means over the axis, each gradient rounded once to its
    leaf's dtype; then the optimizer steps on the local leaves.

An axis of size 1 makes no collective, so a (1, 1) mesh is the single-card
step bit for bit. Checkpoints use torch.save and torch.load; orbax has no
counterpart here. On a mesh the file holds the global params and optimizer
state, gathered over the model axis and written by rank (0, 0) in the
single-card layout, so a checkpoint restores onto one card or onto any mesh
whose model axis splits the heads.

The serving half of the sharded layer is here too (:37-65, :182-217):
`shard_params` (this rank's local tensors), `_local_cfg` and `spmd_forward`
(the inference forward on local head shards, with an all-reduce over the
model axis after wo and after w_down, parallel/comm.py). parallel/serve.py
runs the sharded engine on them.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.models.inference import _prefill
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor
from tiny_flash_attention_tpu_torch.parallel import comm
from tiny_flash_attention_tpu_torch.utils.device import resolve_device

# the dimension of each layer leaf cut over the model axis (None: replicated)
_LAYER_SPEC = {"attn_norm": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
               "mlp_norm": None, "w_gate": 1, "w_up": 1, "w_down": 0}


def param_leaves(params: dict) -> list:
    """The param tensors in a fixed order: the optimizer's state follows it,
    so a checkpoint restores into any params of the same config."""
    return [params["embed"],
            *(layer[name] for layer in params["layers"]
              for name in sorted(layer)),
            params["final_norm"], params["lm_head"]]


def _params_from_leaves(leaves: list, n_layers: int) -> dict:
    """param_leaves' inverse."""
    it = iter(leaves)
    embed = next(it)
    layers = [{name: next(it) for name in sorted(_LAYER_SPEC)}
              for _ in range(n_layers)]
    return {"embed": embed, "layers": layers, "final_norm": next(it),
            "lm_head": next(it)}


def _map_params(fn, params: dict) -> dict:
    return {"embed": fn(params["embed"]),
            "layers": [{name: fn(t) for name, t in layer.items()}
                       for layer in params["layers"]],
            "final_norm": fn(params["final_norm"]),
            "lm_head": fn(params["lm_head"])}


# --- the mesh -----------------------------------------------------------------


def _axis(mesh: DeviceMesh, name: str) -> tuple[int, int]:
    """(size, this rank's index) of a mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(name)), \
        mesh.get_local_rank(name)


@dataclasses.dataclass(frozen=True)
class _Place:
    """This rank's place on the mesh."""
    tp: int
    model_group: object
    dp: int
    group: int                    # its data group's index
    data_group: object            # None without a data axis
    model: int = 0                # its index on the model axis

    @classmethod
    def of(cls, mesh: DeviceMesh, model_axis: str,
           data_axis: Optional[str]) -> "_Place":
        tp, m = _axis(mesh, model_axis)
        dp, g = _axis(mesh, data_axis) if data_axis else (1, 0)
        return cls(tp, mesh.get_group(model_axis), dp, g,
                   mesh.get_group(data_axis) if data_axis else None, m)


def _mesh_device(mesh: DeviceMesh, device) -> torch.device:
    device = resolve_device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"a {mesh.device_type} mesh, device {device}")
    return device


def _mesh_barrier(place: _Place) -> None:
    """Every rank of the mesh has arrived: a barrier over the model axis,
    then one over the data axis (axes of one rank make none)."""
    for group, n in ((place.model_group, place.tp),
                     (place.data_group, place.dp)):
        if n > 1:
            dist.barrier(group=group)


# --- tensor parallelism: the cut of the params -------------------------------


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


def _leaf_dims(n_layers: int) -> list:
    """param_specs' dimension of each leaf, in param_leaves order."""
    return param_leaves({"embed": None, "layers": [_LAYER_SPEC] * n_layers,
                         "final_norm": None, "lm_head": None})


def _local_cfg(cfg: T.ModelConfig, tp: int) -> T.ModelConfig:
    """The config of one rank's head shard (JAX asserts, :182-187)."""
    if cfg.n_q_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"heads ({cfg.n_q_heads}q/{cfg.n_kv_heads}kv) not "
                         f"divisible by tp={tp}")
    return dataclasses.replace(cfg, n_q_heads=cfg.n_q_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp)


def _block(t: torch.Tensor, dim: Optional[int], tp: int, r: int):
    """Rank r's block of t along dim over tp ranks, a fresh contiguous
    tensor; t itself where dim is None."""
    if dim is None:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over tp={tp}")
    size = t.shape[dim] // tp
    return t.narrow(dim, r * size, size).clone(
        memory_format=torch.contiguous_format)


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
        return _block(t, dim, tp, r)

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
    single-card residual add, bit for bit, and so is its gradient."""
    return x + comm.all_reduce(out.float(), group).to(x.dtype)


# --- the train step -----------------------------------------------------------


def sharded_attention(mesh: DeviceMesh):
    """The attention island of the sharded step (:67-79): flash attention
    with batch on 'data' and heads on 'model'. A rank's q, k and v are its
    batch block's and head block's already, each q head beside its kv
    head, so the island is the flash entry on them, with no collective: B1
    forward and the backward kernels in backward() on the card. `causal`
    and `window` are passed on as JAX passes them."""
    def attn(q, k, v, *, causal: bool = True, window=None):
        if q.device.type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type} mesh, q on {q.device}")
        return flash_attention(q, k, v, causal=causal, window=window)

    return attn


def make_sharded_model_cfg(cfg: T.ModelConfig,
                           mesh: DeviceMesh) -> T.ModelConfig:
    """The config a rank's layer loop runs on the mesh: its head shard
    (:82-84; JAX's names the island, which the port passes to the layer
    loop as its attention). Heads that do not split over 'model' raise
    ValueError."""
    return _local_cfg(cfg, _axis(mesh, "model")[0])


def _sharded_loss(cfg: T.ModelConfig, mesh: DeviceMesh, place: _Place):
    """loss(params, tokens): the next-token NLL of this rank's batch block
    through its head shard: _prefill's layer loop with f, the island (or
    the plain attention of attn_impl="reference") and row_parallel_add."""
    cfg_local = make_sharded_model_cfg(cfg, mesh)
    if cfg.attn_impl == "flash":
        island = sharded_attention(mesh)

        def attend(q, k, v):
            return island(q, k, v, causal=True, window=cfg.attn_window)
    else:
        def attend(q, k, v):
            return T._attention(cfg_local, q, k, v, causal=True)
    add = functools.partial(row_parallel_add, group=place.model_group)
    enter = functools.partial(comm.enter_model, group=place.model_group)

    def loss(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        logits = _prefill(cfg_local, params, tokens, positions, attend, add,
                          enter)[0]
        return T.next_token_nll(logits, tokens)

    return loss


def _data_block(tokens: torch.Tensor, place: _Place) -> torch.Tensor:
    if tokens.shape[0] % place.dp:
        raise ValueError(f"a global batch of {tokens.shape[0]} does not "
                         f"split over data={place.dp}")
    b = tokens.shape[0] // place.dp
    return tokens[place.group * b:(place.group + 1) * b]


def _data_mean(leaves: list, loss: torch.Tensor, group) -> torch.Tensor:
    """The mean over the data axis of every leaf's gradient, in place, and
    of the loss: one all-reduce of a flat f32 buffer that holds them all
    (on gloo each collective stages through the host), each gradient
    rounded once to its leaf's dtype. Returns the mean loss, 0-dim f32."""
    flat = torch.cat([p.grad.reshape(-1).float() for p in leaves]
                     + [loss.reshape(1).float()])
    flat = comm.all_reduce(flat, group).div_(dist.get_world_size(group))
    at = 0
    for p in leaves:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
        at += p.numel()
    return flat[at].clone()


def make_train_step(
        cfg: T.ModelConfig, mesh: Optional[DeviceMesh] = None, *,
        learning_rate: float = 1e-3,
        optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
        device=None):
    """Returns (train_step, init_state).

    init_state(params) -> (params, opt_state): copies the params onto
    `device` (default: the card) as leaves that require grad and builds the
    optimizer over them; the caller's tensors are left as they are. On a
    mesh, `params` are the global params, the same on every rank, and the
    leaves are this rank's shard_params blocks (quantized weights raise
    ValueError). `optimizer` takes the list of param leaves and returns a
    torch.optim.Optimizer (e.g. `lambda ps: torch.optim.SGD(ps, lr=1e-2)`).
    The default is `optax.adamw(learning_rate)` as a torch AdamW: b1 0.9,
    b2 0.999, eps 1e-8 and weight decay 1e-4 (optax's default, not torch's
    1e-2) on every leaf. torch decays the param before the Adam step and
    optax adds the decay to the update; both give p (1 - lr wd) - lr adam.

    train_step(params, opt_state, tokens) -> (params, opt_state, loss):
    tokens (batch, seq) int, the global batch on every rank of a mesh (a
    batch that does not split over 'data' raises ValueError); the loss is
    the step's mean next-token NLL before its update over the global
    batch, a 0-dim f32 tensor on the device, the same bits on every rank
    (reading it syncs with the host; the step itself does not, but on
    gloo each collective stages through the host). params and opt_state
    come back updated in place.

    `mesh`: a DeviceMesh with axes 'data' and 'model' over the ranks of a
    torch.distributed world, of `device`'s type; every rank calls the step
    (each collective's backward runs on every rank, in the same order).
    Heads that do not split over 'model' raise ValueError.
    """
    if optimizer is None:
        def optimizer(leaves: list) -> torch.optim.Optimizer:
            return torch.optim.AdamW(leaves, lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=1e-4)
    if mesh is None:
        device, place = resolve_device(device), None

        def loss_of(params, tokens):
            return T.loss_fn(cfg, params, tokens)
    else:
        device = _mesh_device(mesh, device)
        place = _Place.of(mesh, "model", "data")
        loss_of = _sharded_loss(cfg, mesh, place)

    def init_state(params: dict):
        if mesh is not None:
            params = shard_params(params, mesh, cfg)
        params = _map_params(
            lambda t: t.detach().to(device, copy=True).requires_grad_(True),
            params)
        return params, optimizer(param_leaves(params))

    def train_step(params: dict, opt_state: torch.optim.Optimizer, tokens):
        tokens = torch.as_tensor(tokens, device=device)
        if place is not None:
            tokens = _data_block(tokens, place)
        opt_state.zero_grad(set_to_none=True)
        loss = loss_of(params, tokens)
        loss.backward()
        loss = loss.detach()
        if place is not None and place.dp > 1:
            loss = _data_mean(param_leaves(params), loss, place.data_group)
        opt_state.step()
        return params, opt_state, loss

    return train_step, init_state


# --- checkpoints --------------------------------------------------------------


def _state_tensors(opt_sd: dict, fn) -> dict:
    """An optimizer state_dict with fn(leaf index, tensor) applied to each
    state tensor of more than 0 dimensions (AdamW's moments, SGD's
    momentum; its step counts stay), in index order."""
    state = {i: {k: fn(i, v) if isinstance(v, torch.Tensor) and v.dim()
                 else v for k, v in opt_sd["state"][i].items()}
             for i in sorted(opt_sd["state"])}
    return {**opt_sd, "state": state}


def save_train_state(path: str, params: dict,
                     opt_state: torch.optim.Optimizer, *, step: int = 0,
                     mesh: Optional[DeviceMesh] = None):
    """Checkpoints the train state: the params, the optimizer's state_dict
    and the step. `path` is created; the checkpoint lands at
    `path`/state.pt. On a mesh every rank calls it: the params and the
    optimizer's per-leaf tensors are gathered over the model axis into the
    global ones, and rank (0, 0) writes them, between barriers over the
    mesh, in the single-card layout."""
    params = _map_params(torch.Tensor.detach, params)
    opt_sd = opt_state.state_dict()
    write = True
    if mesh is not None:
        place = _Place.of(mesh, "model", "data")
        dims = _leaf_dims(len(params["layers"]))

        def whole(t, dim):
            if dim is None or place.tp == 1:
                return t
            return comm.all_gather(t, place.model_group, dim)

        params = _params_from_leaves(
            [whole(t, d) for t, d in zip(param_leaves(params), dims)],
            len(params["layers"]))
        opt_sd = _state_tensors(opt_sd, lambda i, t: whole(t, dims[i]))
        write = place.group == 0 and place.model == 0
        _mesh_barrier(place)
    if write:
        os.makedirs(path, exist_ok=True)
        torch.save({"params": params, "opt_state": opt_sd,
                    "step": int(step)}, os.path.join(path, "state.pt"))
    if mesh is not None:
        _mesh_barrier(place)


def restore_train_state(path: str, params: dict,
                        opt_state: torch.optim.Optimizer,
                        mesh: Optional[DeviceMesh] = None,
                        cfg: Optional[T.ModelConfig] = None):
    """Restores a checkpoint of save_train_state into `params` and
    `opt_state` in place (e.g. those of a fresh init_state, which give the
    structure, shapes and dtypes), so the optimizer stays bound to the
    param leaves. On a mesh, the global tensors of the file are cut by
    param_specs into this rank's blocks (a file written on any mesh, or on
    one card, restores onto any mesh whose model axis splits the heads;
    with `cfg`, heads that do not split raise ValueError). Returns
    (params, opt_state, step)."""
    leaves = param_leaves(params)
    state = torch.load(os.path.join(path, "state.pt"),
                       map_location=leaves[0].device, weights_only=True)
    saved = param_leaves(state["params"])
    opt_sd = state["opt_state"]
    if mesh is not None:
        place = _Place.of(mesh, "model", "data")
        if cfg is not None:
            _local_cfg(cfg, place.tp)
        dims = _leaf_dims(len(params["layers"]))

        def cut(t, dim):
            return _block(t, dim, place.tp, place.model)

        saved = [cut(t, d) for t, d in zip(saved, dims)]
        opt_sd = _state_tensors(opt_sd, lambda i, t: cut(t, dims[i]))
    if [t.shape for t in saved] != [t.shape for t in leaves]:
        raise ValueError("the checkpoint's params do not match these params")
    with torch.no_grad():
        for dst, src in zip(leaves, saved):
            dst.copy_(src)
    opt_state.load_state_dict(opt_sd)
    return params, opt_state, int(state["step"])


# --- the inference forward on a head shard (the serving path) ----------------


def spmd_forward(cfg_local: T.ModelConfig, params: dict,
                 tokens: torch.Tensor, model_group) -> torch.Tensor:
    """The inference forward on this rank's head shard (:190-217):
    tokens (b, s) -> logits (b, s, vocab) f32, the same on every rank of
    `model_group` (the model axis's process group, `mesh.get_group(
    "model")`). cfg_local is `_local_cfg(cfg, tp)` and params this rank's
    `shard_params`; attention is B1 on the local heads. Inference only:
    without f on the column-cut inputs its gradients would be partial
    (the train step is make_train_step on the mesh)."""
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return _prefill(cfg_local, params, tokens, positions,
                    lambda q, k, v: T._attention(cfg_local, q, k, v,
                                                 causal=True),
                    functools.partial(row_parallel_add,
                                      group=model_group))[0]
