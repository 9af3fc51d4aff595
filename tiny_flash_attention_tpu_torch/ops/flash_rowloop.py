"""Row-loop flash-attention forward: the jagged admission's attention.

Counterpart of tiny_flash_attention_tpu/ops/flash_rowloop.py::
flash_attention_rowloop. The TPU kernel moves the KV walk of a q row block
inside one grid step, with a dynamic trip count, and in its jagged mode
clamps that walk to each batch row's runtime length. A Hopper flash block
walks its KV range in a loop already, so the port is the jagged mode of
csrc/flash_fwd.cu (one more bound on that loop, the `seq_lens` operand),
launched and counted here as a kernel of its own.

On CUDA the kernel runs, its sliding window included (without
`seq_lengths`: JAX's jagged mode takes no window either). On the CPU the
plain version, `flash_attention_rowloop_plain`, runs. `config` is the
port's FlashConfig (ops/configs.py), as every flash entry's: the launch's
narrow instances and f32 runs. The TPU tuning arguments (`chunk`,
`unroll`, `single_loop`, `interpret`) have no meaning on Hopper and are not
taken.

One divergence from JAX: rows at or past `seq_lengths[b]`, which the TPU
kernel leaves as garbage for the caller to slice off, are empty rows here
(out 0, LSE the sentinel m * ln2), in the kernel and in the plain version.
The engine writes K/V up to the page-padded length into its cache, so those
rows must stay finite; the kernel skips their work besides.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tiny_flash_attention_tpu_torch.ops import flash as F
from tiny_flash_attention_tpu_torch.ops.configs import (
    FlashConfig, resolve_config)
from tiny_flash_attention_tpu_torch.utils.autograd import forward_only


def flash_attention_rowloop(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            window: Optional[int] = None, seq_lengths=None,
                            config: Optional[FlashConfig] = None):
    """Row-loop forward; returns (out, lse). The semantics of
    `ops/flash.flash_attention` minus segment ids: GQA, causal with the
    decode offset, non-causal, and with `seq_lengths` (batch,) int32 runtime
    lengths the jagged mode (causal, q_len == kv_len, no window): row b
    attends its first seq_lengths[b] tokens, and its rows past that length
    are empty (out 0, the LSE sentinel). `config` as in `flash_attention`:
    checked before any launch, nothing on the CPU.
    """
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, dk = k.shape
    if dk != d or v.shape != k.shape:
        raise ValueError(f"shapes {q.shape}, {k.shape}, {v.shape}")
    if hq % hkv:
        raise ValueError(f"GQA needs q_heads {hq} % kv_heads {hkv} == 0")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True")
    if seq_lengths is not None and not (causal and q_len == kv_len
                                        and window is None):
        raise ValueError("seq_lengths = jagged causal prefill (q_len == "
                         "kv_len, no window)")
    config = resolve_config(config)
    if q.is_cuda:
        lens = None
        if seq_lengths is not None:
            lens = F.as_int32(seq_lengths, (bs,), q)

        def launch():
            out = F.launch_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               seq_lengths=lens, window=window,
                               config=config)
            flash_attention_rowloop.launches += 1
            return out
        return forward_only("flash_attention_rowloop", launch, q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_rowloop_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale, window=window,
                                         seq_lengths=seq_lengths)


flash_attention_rowloop.launches = 0   # kernel launches


def flash_attention_rowloop_plain(q, k, v, *, causal: bool, sm_scale: float,
                                  window: Optional[int] = None,
                                  seq_lengths=None):
    """Plain PyTorch version with the kernel's semantics; returns (out,
    lse). The jagged lengths are segment ids of the plain flash forward:
    columns below L carry id 1, rows below L id 1 and rows past it an id no
    column has, so they are empty rows."""
    ids = None
    if seq_lengths is not None:
        lens = torch.as_tensor(seq_lengths, device=q.device)
        valid = (torch.arange(q.shape[2], device=q.device)[None, :]
                 < lens[:, None])
        ids = (torch.where(valid, 1, -1), torch.where(valid, 1, -2))
    return F.flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                   segment_ids=ids, window=window,
                                   return_lse=True)
