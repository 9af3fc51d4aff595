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

The sharded trainer (`param_specs`, `shard_params`, `sharded_attention`,
`spmd_forward`) is still to port; it will stand on parallel/sharded.py's
mesh. This module has no mesh argument.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from tiny_flash_attention_tpu_torch.models import transformer as T
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
