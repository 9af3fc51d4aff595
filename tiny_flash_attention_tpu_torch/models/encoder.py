"""Encoder model family: a bidirectional transformer for embeddings.

Port of tiny_flash_attention_tpu/models/encoder.py. The same parameters and
blocks as the decoder (transformer.py: `init_params`, `params_from_jax`),
with non-causal attention and pad isolation by segment ids: valid tokens get
id 1, pad tokens id 2, so a pad row attends only pads and an embedding does
not depend on how much padding its batch row carries. Pooling is the masked
mean over valid positions, then an L2 normalization.

With attn_impl="flash" attention is `flash_attention(causal=False,
segment_ids=(seg, seg))`: the forward kernel with its segment mask on the
card, its plain version on the CPU. attn_impl="reference" is the explicit
masked softmax of the JAX oracle path.
"""

from __future__ import annotations

import torch

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention


def _enc_attention(cfg: T.ModelConfig, q, k, v, seg):
    """Bidirectional attention with pad isolation via segment ids."""
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=False, segment_ids=(seg, seg))
    if cfg.attn_impl != "reference":
        raise ValueError(f"attn_impl {cfg.attn_impl!r}")
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.matmul(q.float(), kk.transpose(-1, -2)) * q.shape[-1] ** -0.5
    same = seg[:, None, :, None] == seg[:, None, None, :]
    p = torch.softmax(torch.where(same, s, -1e30), dim=-1)
    return torch.matmul(p, vv).to(q.dtype)


def encode(cfg: T.ModelConfig, params: dict, tokens: torch.Tensor,
           lengths=None):
    """tokens (b, s), lengths (b,) valid prefix lengths (None: all valid)
    -> (hidden (b, s, d_model), pooled (b, d_model) f32). The segment ids
    are made on the device once, before the layer loop."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    lengths = (torch.full((b,), s, device=tokens.device) if lengths is None
               else torch.as_tensor(lengths, device=tokens.device))
    valid = positions[None, :] < lengths[:, None]               # (b, s)
    seg = torch.where(valid, 1, 2).to(torch.int32)

    x = params["embed"][tokens.long()].to(cfg.dtype)
    for layer in params["layers"]:
        q, k, v = T.qkv_proj(cfg, layer, x, positions)
        o = _enc_attention(cfg, q, k, v, seg)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_q_heads * cfg.d_head)
        x = x + T._proj(o, layer["wo"])
        x = T.mlp_block(cfg, layer, x)
    x = T.rms_norm(x, params["final_norm"], cfg.rms_eps)

    mask = valid[..., None].float()
    pooled = (x.float() * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
    return x, pooled


def embed_texts(cfg: T.ModelConfig, params: dict, tokens: torch.Tensor,
                lengths=None) -> torch.Tensor:
    """L2-normalized sentence embeddings (b, d_model) f32."""
    _, pooled = encode(cfg, params, tokens, lengths)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-6)
