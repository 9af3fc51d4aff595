"""GQA decoder-only transformer (RMSNorm -> GQA attention with RoPE ->
SwiGLU MLP), ported from tiny_flash_attention_tpu/models/transformer.py.

Parameters are plain dicts of tensors, with the layers as a list of dicts
(the JAX package stacks them on a leading axis for lax.scan; here a Python
loop walks the list). The bf16 rounding points follow the JAX functions:
projections accumulate in f32 and round once to the activation dtype,
rms_norm rounds before the gamma multiply, RoPE and SiLU compute in f32.
`loss_fn` is the training objective; every parameter is a leaf tensor, so
the trainer (parallel/train.py) can ask for its gradient.
`quantize_params` makes the weight-only int8/fp8 variant: every projection
becomes a QuantizedTensor (per-output-channel scales) and `_proj` sends it
through `quantized_matmul`. `attn_window` makes it a sliding-window
(Mistral-style) model: attention sees the last `attn_window` positions, in
the forward kernel's window mode; such a model serves on the card (the
decode's ring mode), and its backward raises there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tiny_flash_attention_tpu_torch.ops import quant as Q
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
from tiny_flash_attention_tpu_torch.ops.reference import mha_reference
from tiny_flash_attention_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    n_q_heads: int = 8
    n_kv_heads: int = 2
    d_head: int = 128
    d_ff: int = 2816
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # "flash" (the forward kernel) | "reference" (plain mha_reference)
    attn_impl: str = "flash"
    # optional sliding-window attention (Mistral-style); None = full causal
    attn_window: Optional[int] = None

    @property
    def group(self) -> int:
        return self.n_q_heads // self.n_kv_heads


_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """He-style init from `generator` (normal / sqrt(fan_in), norms at 1),
    stored in cfg.dtype on `device` (default: the card). The numbers differ
    from JAX's init_params for the same seed; `params_from_jax` carries
    JAX's weights over."""
    device = resolve_device(device)

    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) / math.sqrt(scale_dim)
        return w.to(device=device, dtype=cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    dm, dh = cfg.d_model, cfg.d_head
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(dm),
            "wq": dense((dm, cfg.n_q_heads * dh), dm),
            "wk": dense((dm, cfg.n_kv_heads * dh), dm),
            "wv": dense((dm, cfg.n_kv_heads * dh), dm),
            "wo": dense((cfg.n_q_heads * dh, dm), cfg.n_q_heads * dh),
            "mlp_norm": ones(dm),
            "w_gate": dense((dm, cfg.d_ff), dm),
            "w_up": dense((dm, cfg.d_ff), dm),
            "w_down": dense((cfg.d_ff, dm), cfg.d_ff),
        })
    return {
        "embed": dense((cfg.vocab_size, dm), dm) * math.sqrt(dm),
        "layers": layers,
        "final_norm": ones(dm),
        "lm_head": dense((dm, cfg.vocab_size), dm),
    }


def _from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: JAX hands out read-only
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: same bits, read through a 16-bit integer view
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf_from_jax(a, device: torch.device, layer: Optional[int] = None):
    """A JAX leaf (a numpy array, or anything with `.values` and `.scales`
    such as JAX's QuantizedTensor) -> a tensor or a QuantizedTensor; with
    `layer`, the slice of the stacked leading axis."""
    def take(x):
        return _from_numpy(x if layer is None else x[layer], device)
    if hasattr(a, "values") and hasattr(a, "scales"):
        return Q.QuantizedTensor(take(a.values), take(a.scales))
    return take(a)


def params_from_jax(tree: dict, device=None) -> dict:
    """JAX params (every leaf a numpy array, e.g. `jax.tree.map(np.asarray,
    params)`, quantized ones included) -> the port's params, bit for bit,
    with the stacked `layers` axis split into a list of per-layer dicts (a
    quantized projection's (L, K, N) values and (L, 1, N) scales too)."""
    device = resolve_device(device)
    stacked = tree["layers"]
    n_layers = stacked["attn_norm"].shape[0]
    return {
        "embed": _leaf_from_jax(tree["embed"], device),
        "layers": [{k: _leaf_from_jax(stacked[k], device, i)
                    for k in _LAYER_KEYS} for i in range(n_layers)],
        "final_norm": _leaf_from_jax(tree["final_norm"], device),
        "lm_head": _leaf_from_jax(tree["lm_head"], device),
    }


def quantized_from_jax(qt, device=None) -> Q.QuantizedTensor:
    """A JAX QuantizedTensor (its values and scales as numpy arrays, e.g.
    `jax.tree.map(np.asarray, qt)`) -> the port's, byte for byte: int8 as
    it is, ml_dtypes float8_e4m3fn through a uint8 view."""
    return _leaf_from_jax(qt, resolve_device(device))


def quantize_params(params: dict, fmt: str = "int8") -> dict:
    """Weight-only quantization of every projection and the lm_head, with
    per-output-channel scales; the embedding and the norms stay."""
    out = dict(params)
    out["layers"] = [{name: (Q.quantize_weight(w, fmt)
                             if name in _QUANT_KEYS else w)
                      for name, w in layer.items()}
                     for layer in params["layers"]]
    out["lm_head"] = Q.quantize_weight(params["lm_head"], fmt)
    return out


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w accumulated in f32 and rounded once to x's dtype; a
    QuantizedTensor weight goes through `quantized_matmul`.

    On the card cuBLAS accumulates bf16 products in f32 and rounds once, as
    long as `torch.backends.cuda.matmul.allow_bf16_reduced_precision_
    reduction` is False (chip_smoke.py sets it): otherwise a split-K
    reduction may add partial sums in bf16."""
    if isinstance(w, Q.QuantizedTensor):
        return Q.quantized_matmul(x, w)
    if x.device.type == "cpu":
        return torch.matmul(x.float(), w.float()).to(x.dtype)
    return torch.matmul(x, w)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding in f32. x: (b, h, s, d); positions: (b, s) or (s,)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(cfg: ModelConfig, q, k, v, *, causal: bool = True):
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=causal,
                               window=cfg.attn_window)
    if cfg.attn_impl == "reference":
        if cfg.attn_window is not None:
            raise ValueError("a sliding window needs attn_impl='flash'")
        return mha_reference(q, k, v, causal=causal).to(q.dtype)
    raise ValueError(f"attn_impl {cfg.attn_impl!r}")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def qkv_proj(cfg: ModelConfig, layer: dict, x: torch.Tensor,
             positions: torch.Tensor, enter=_identity):
    """x (b, s, dm) -> q (b, hq, s, dh), k/v (b, hkv, s, dh) with RoPE.
    `enter` takes the normed input before the column-cut products (the
    model axis's f in the sharded train step, parallel/train.py)."""
    b, s, _ = x.shape
    xn = enter(rms_norm(x, layer["attn_norm"], cfg.rms_eps))
    q = _proj(xn, layer["wq"]).view(b, s, cfg.n_q_heads, cfg.d_head)
    k = _proj(xn, layer["wk"]).view(b, s, cfg.n_kv_heads, cfg.d_head)
    v = _proj(xn, layer["wv"]).view(b, s, cfg.n_kv_heads, cfg.d_head)
    q = rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions, cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def attn_block(cfg: ModelConfig, layer: dict, x: torch.Tensor,
               positions: torch.Tensor):
    b, s, _ = x.shape
    q, k, v = qkv_proj(cfg, layer, x, positions)
    o = _attention(cfg, q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_q_heads * cfg.d_head)
    return x + _proj(o, layer["wo"])


def mlp_down(cfg: ModelConfig, layer: dict, x: torch.Tensor,
             enter=_identity):
    """The SwiGLU MLP's output before the residual add: its w_down
    product, rounded to x's dtype. `enter` as in qkv_proj."""
    xn = enter(rms_norm(x, layer["mlp_norm"], cfg.rms_eps))
    g = _proj(xn, layer["w_gate"]).float()
    gate = g * torch.sigmoid(g)          # silu in f32, as jax.nn.silu
    up = _proj(xn, layer["w_up"]).float()
    return _proj((gate * up).to(x.dtype), layer["w_down"])


def mlp_block(cfg: ModelConfig, layer: dict, x: torch.Tensor):
    return x + mlp_down(cfg, layer, x)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal forward: tokens (b, s) -> logits (b, s, vocab) f32."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for layer in params["layers"]:
        x = attn_block(cfg, layer, x, positions)
        x = mlp_block(cfg, layer, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _proj(x, params["lm_head"]).float()


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor):
    """Next-token cross-entropy of f32 logits (b, s, vocab), the mean over
    every position but the last (transformer.py:198-204): log-softmax, as
    `F.cross_entropy` computes it."""
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def loss_fn(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """The training objective: next_token_nll of the forward's logits."""
    return next_token_nll(forward(cfg, params, tokens), tokens)
