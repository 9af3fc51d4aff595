"""Inference paths: batched, packed and jagged prefill; the paged decode step.

Port of tiny_flash_attention_tpu/models/inference.py for bf16 and int8
pages. The JAX functions are jitted and donate the pages buffer
(`donate_argnums`); here every decode write updates the page tensors IN
PLACE, and the pages list the caller passed is the one returned. `lax.scan`
over stacked layers becomes a loop over the layer list, and `decode_loop`'s
scan over steps a Python loop that keeps the sampled tokens on the device
until the end. The decode step's append is the hand-written append kernel
on the card (`_append_rows`), where the JAX engine runs an XLA scatter.
The packed and jagged prefills make their kernel operands (segment ids and
the tile table, the lengths) on the device once, before the layer loop. A
sliding-window model (`cfg.attn_window`) prefills through the forward
kernel's window and decodes through the ring mode of the decode kernel,
whose lengths run past the table's capacity.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, segment_tiles)
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop)
from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    fused_page_append, fused_paged_decode_attention)


def _add(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return x + out


def _prefill(cfg: T.ModelConfig, params: dict, tokens: torch.Tensor,
             positions: torch.Tensor, attend: Callable, add: Callable = _add,
             enter: Callable = T._identity):
    """The layer loop of every prefill and of the sharded train step:
    `attend(q, k, v)` is its attention, `add(x, out)` the residual add
    after wo and after w_down (a row-parallel sum in the sharded paths,
    parallel/train.py), `enter(xn)` takes the normed input of the
    column-cut products (the model axis's f in the sharded train step).
    Returns (logits f32, k_layers, v_layers)."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    ks, vs = [], []
    for layer in params["layers"]:
        q, k, v = T.qkv_proj(cfg, layer, x, positions, enter)
        o = attend(q, k, v)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_q_heads * cfg.d_head)
        x = add(x, T._proj(o, layer["wo"]))
        x = add(x, T.mlp_down(cfg, layer, x, enter))
        ks.append(k)
        vs.append(v)
    x = T.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = T._proj(x, params["lm_head"]).float()
    return logits, torch.stack(ks), torch.stack(vs)


def prefill_forward_batched(cfg: T.ModelConfig, params: dict,
                            tokens: torch.Tensor):
    """tokens (B, L) -> (logits (B, L, V) f32, k_layers, v_layers).

    k_layers/v_layers: (n_layers, B, hkv, L, d) post-RoPE, ready for cache
    writes. Attention runs causally over the full (right-padded) prompts;
    the padding is harmless: cache writes slice by true length and padded
    rows never mix into earlier positions under the causal mask.
    """
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return _prefill(cfg, params, tokens, positions,
                    lambda q, k, v: T._attention(cfg, q, k, v, causal=True))


def prefill_forward_packed(cfg: T.ModelConfig, params: dict,
                           tokens: torch.Tensor, seg_ids: torch.Tensor,
                           positions: torch.Tensor, *, segment_starts,
                           add: Callable = _add):
    """Ragged prompts PACKED into one row: tokens/seg_ids (1, L_total),
    positions (L_total,) restarting at each prompt (RoPE), segment_starts
    the static pack offsets.

    Attention is the flash kernel with the segment mask and each q tile's
    kv range pruned to its segment (`segment_tiles`), so the cost is
    sum(L_i^2)/2, not B * L_max^2 / 2. Returns (logits (1, L, V), ks, vs)
    shaped like prefill_forward_batched with B=1. `add` as in _prefill
    (the sharded engine's row-parallel sum).
    """
    seg = seg_ids.to(device=tokens.device, dtype=torch.int32)
    tiles = segment_tiles(segment_starts, tokens.shape[1], causal=True,
                          device=tokens.device)
    return _prefill(cfg, params, tokens, positions,
                    lambda q, k, v: flash_attention(
                        q, k, v, causal=True, segment_ids=(seg, seg),
                        segment_starts=tiles), add)


def prefill_forward_jagged(cfg: T.ModelConfig, params: dict,
                           tokens: torch.Tensor, seq_lengths,
                           add: Callable = _add):
    """A heterogeneous batch WITHOUT packing: tokens (B, L_pad) right-padded
    per request, seq_lengths (B,) runtime lengths.

    Attention is the row-loop kernel (ops/flash_rowloop.py), whose kv walk
    clamps to each row's length: ~sum(L_i^2)/2 like packed admission, with
    one shape per (B, L_pad) bucket. Returns (logits (B, L_pad, V), ks, vs);
    rows past a request's length are not its tokens (their attention rows
    are empty rows, so they stay finite) and are sliced off by the caller.
    `add` as in _prefill.
    """
    lens = torch.as_tensor(seq_lengths, device=tokens.device).to(torch.int32)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return _prefill(cfg, params, tokens, positions,
                    lambda q, k, v: flash_attention_rowloop(
                        q, k, v, causal=True, seq_lengths=lens)[0], add)


def prefill_forward(cfg: T.ModelConfig, params: dict, tokens: torch.Tensor):
    """tokens (1, L) -> (logits (1, L, V), k_layers, v_layers), the layers
    squeezed to (n_layers, hkv, L, d)."""
    logits, ks, vs = prefill_forward_batched(cfg, params, tokens)
    return logits, ks[:, 0], vs[:, 0]


def _decode_core(cfg: T.ModelConfig, params: dict, pages: List[torch.Tensor],
                 tokens: torch.Tensor, positions: torch.Tensor,
                 page_table: torch.Tensor, *, page_size: int, fmt: str,
                 add: Callable = _add):
    """One decode step; see decode_step. `add` as in _prefill."""
    B = tokens.shape[0]
    ps = page_size
    width = page_table.shape[1]
    x = params["embed"][tokens.long()][:, None, :].to(cfg.dtype)  # (B,1,dm)
    # a chunked-decode overrun of a finished request can push positions
    # past the table's capacity: the WRITE wraps onto the slot's own pages
    # (the tokens are discarded) and the attended length stops at the
    # table. A windowed model's table is a ring: its lengths are not
    # clamped, and the decode attends the last window of them.
    lengths = positions + 1
    if cfg.attn_window is None:
        lengths = torch.clamp(lengths, max=width * ps)
    lengths = lengths.to(torch.int32)
    page_ids = torch.gather(page_table, 1,
                            ((positions // ps) % width)[:, None].long())[:, 0]
    rows = positions % ps
    for li, layer in enumerate(params["layers"]):
        q, k, v = T.qkv_proj(cfg, layer, x, positions[:, None])
        # q (B, hq, 1, d); k/v (B, hkv, 1, d). Append before attending:
        # the current token attends to itself.
        _append_rows(pages[li], k[:, :, 0], v[:, :, 0], page_ids, rows,
                     page_size=ps, fmt=fmt)
        o, _ = fused_paged_decode_attention(q[:, :, 0], pages[li], lengths,
                                            page_table, page_size=ps,
                                            window=cfg.attn_window)
        o = o.reshape(B, 1, cfg.n_q_heads * cfg.d_head).to(cfg.dtype)
        x = add(x, T._proj(o, layer["wo"]))
        x = add(x, T.mlp_down(cfg, layer, x))
    x = T.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = T._proj(x[:, 0], params["lm_head"]).float()
    return logits, pages


def decode_step(cfg: T.ModelConfig, params: dict, pages: List[torch.Tensor],
                tokens: torch.Tensor, positions: torch.Tensor,
                page_table: torch.Tensor, *, page_size: int, fmt: str):
    """One decode step for all slots (fixed shape: continuous batching).

    tokens (B,) int: last sampled token per slot. positions (B,) int32:
    index of this token (the old cache length). page_table (B, P) int32.
    Each layer appends its new K/V row into its pages IN PLACE before
    attending, so attention covers positions + 1 tokens. Returns
    (logits (B, V) f32, pages), the same page tensors the caller passed.
    """
    return _decode_core(cfg, params, pages, tokens, positions, page_table,
                        page_size=page_size, fmt=fmt)


def decode_loop(cfg: T.ModelConfig, params: dict, pages: List[torch.Tensor],
                tokens: torch.Tensor, positions: torch.Tensor,
                page_table: torch.Tensor, temps: torch.Tensor,
                generator: torch.Generator, *, page_size: int, fmt: str,
                n_steps: int, greedy: bool = False):
    """n_steps decode steps with sampling on the device, pages updated in
    place. greedy=True takes the argmax fast path (no random draws) for a
    batch whose temperatures are all zero.

    Returns (pages, sampled (n_steps, B) int32 on the device, generator).
    """
    sampled = []
    row_ids = torch.arange(tokens.shape[0], device=tokens.device)
    for _ in range(n_steps):
        logits, pages = _decode_core(cfg, params, pages, tokens, positions,
                                     page_table, page_size=page_size,
                                     fmt=fmt)
        if greedy:
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            tokens = sample_tokens_rowwise(logits, generator, temps, row_ids,
                                           n_slots=tokens.shape[0])
        positions = positions + 1
        sampled.append(tokens)
    return pages, torch.stack(sampled), generator


def _check_format(pages: torch.Tensor, fmt: str) -> None:
    if fmt not in ("bf16", "int8"):
        raise ValueError(f"KV format {fmt!r}")
    if (fmt == "int8") != (pages.dtype == torch.int8):
        raise ValueError(f"KV format {fmt!r} over {pages.dtype} pages")


def _append_rows(pages: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, page_ids: torch.Tensor,
                 rows: torch.Tensor, *, page_size: int, fmt: str):
    """In-place token append: pages (hkv, np, prows, d); k_new/v_new
    (B, hkv, d); page_ids/rows (B,). `fused_page_append` for both formats:
    one kernel launch per layer on the card, the scatter decomposition on
    the CPU. (The JAX engine dispatches its scatter everywhere: its Pallas
    append never compiled on the TPU.)"""
    _check_format(pages, fmt)
    return fused_page_append(pages, k_new, v_new, page_ids, rows,
                             page_size=page_size)


def _gumbel_argmax(scaled: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical sample from logits by the Gumbel-max trick."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.argmax(scaled - torch.log(-torch.log(u.clamp_min(tiny))),
                        dim=-1)


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature) -> torch.Tensor:
    """Greedy where temperature == 0, else categorical at that temperature.
    temperature: scalar or per-row (B,) against logits (..., V). The random
    stream is torch's, not jax.random's: only distributions compare."""
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).expand(logits.shape[:-1])
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(t, min=1e-6)[..., None]
    u = torch.rand(scaled.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    return torch.where(t <= 0.0, greedy,
                       _gumbel_argmax(scaled, u)).to(torch.int32)


def sample_tokens_rowwise(logits: torch.Tensor, generator: torch.Generator,
                          temperature, row_ids: torch.Tensor, *,
                          n_slots: int) -> torch.Tensor:
    """sample_tokens with PER-SLOT streams: one draw of n_slots rows of
    uniforms from `generator`, of which batch row r takes row row_ids[r].
    Its token thus depends only on the generator's state, n_slots, its slot
    id and its logits, not on which other slots the batch holds (the JAX
    version folds the row id into the key for the same reason). The draw
    stays on the device: no value comes back to the host."""
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).expand(logits.shape[:-1])
    u = torch.rand((n_slots, logits.shape[-1]), generator=generator,
                   dtype=torch.float32, device=logits.device)[row_ids.long()]
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(t, min=1e-6)[..., None]
    return torch.where(t <= 0.0, greedy,
                       _gumbel_argmax(scaled, u)).to(torch.int32)
