"""Head dims and GQA groups the kernels do not compile, as padding around them.

The JAX package takes any head_dim and any group: its forward and backward
pad head_dim to whole 128-lane tiles with zero columns
(tiny_flash_attention_tpu/ops/flash.py:423-431, ops/flash_bwd.py:478-493),
its decodes pad the q rows of a kv head to a multiple of 8
(ops/paged_fused.py:503-506, ops/paged.py:287), and each slices the result
back. The port's kernels compile a few instances (the flash kernels head_dim
64 and 128; the decodes groups 1, 2, 4 and 8), so the wrappers do the same
with these plain functions:

- `kernel_head_dim` / `pad_head_dim` / `unpad_head_dim`: zero columns up to
  the next instance, 64 below it and 128 up to it. A zero column adds
  exact zeros to every q k^T product, so the scores, the softmax, the LSE
  and the true columns of out and of every gradient are unchanged; the
  padded columns of out and of the gradients come out 0. The softmax
  scale is the caller's, from the true head_dim, never the padded one.
  int8 and e4m3 payloads pad with code 0, an exact zero, and keep their
  scales.
- `decode_group` / `pad_group` / `unpad_group`: zero q rows up to the next
  decode instance, each padded row an independent softmax that is sliced
  away. Above 8, ceil(g / 8) row blocks of 8 q rows read the same pages:
  a G = 16 instance would hold 8 x 16 scores and 16 x D/32 accumulators a
  lane, over the 255 registers a thread may use at head_dim 128.

A head_dim that is already an instance is passed through without a copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# head dims the flash kernels (forward, backward, FA1) compile
FLASH_HEAD_DIMS = (64, 128)
# head dims and q rows a kv head that the decode kernels compile
DECODE_HEAD_DIMS = (64, 80, 96, 128)
DECODE_GROUPS = (1, 2, 4, 8)


def kernel_head_dim(d: int, what: str) -> int:
    """The flash kernels' head_dim that serves d: 64 for d <= 64, 128 for
    d <= 128. Raises NotImplementedError above 128, naming `what` (the
    kernel) and what it takes."""
    for dk in FLASH_HEAD_DIMS:
        if 0 < d <= dk:
            return dk
    raise NotImplementedError(
        f"head_dim {d}: {what} takes head_dim up to {FLASH_HEAD_DIMS[-1]} "
        f"(padded to {' or '.join(map(str, FLASH_HEAD_DIMS))})")


def pad_head_dim(x: torch.Tensor, dk: int) -> torch.Tensor:
    """x (..., d) with dk - d zero columns appended (x itself when d ==
    dk). One-byte payloads (int8, e4m3) pad with code 0 through a byte
    view: both codes are exact zeros."""
    d = x.shape[-1]
    if d == dk:
        return x
    if x.element_size() == 1:
        return F.pad(x.view(torch.uint8), (0, dk - d)).view(x.dtype)
    return F.pad(x, (0, dk - d))


def unpad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """The first d columns of x, contiguous (x itself when it has d)."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def decode_head_dim(d: int, what: str) -> None:
    """Raises NotImplementedError where the decode and append kernels
    compile no instance of head_dim d (their pages are read in place, so
    they are never padded)."""
    if d not in DECODE_HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {d}: {what} takes head_dim {DECODE_HEAD_DIMS} (the "
            f"pages are read in place, never padded)")


def decode_group(group: int) -> tuple[int, int]:
    """(G, blocks): the decode instance's q rows a kv head and the row
    blocks that cover `group` q heads a kv head, G * blocks >= group: the
    least compiled G up to 8, else ceil(group / 8) blocks of 8."""
    if group < 1:
        raise ValueError(f"group {group}")
    for g in DECODE_GROUPS:
        if group <= g:
            return g, 1
    top = DECODE_GROUPS[-1]
    return top, math.ceil(group / top)


def pad_group(q: torch.Tensor, hkv: int, rows: int) -> torch.Tensor:
    """q (batch, hkv * g, ...) -> (batch, hkv * rows, ...): each kv head's g
    q rows followed by rows - g zero rows (q itself when g == rows)."""
    b, hq = q.shape[:2]
    g = hq // hkv
    if g == rows:
        return q
    x = q.reshape(b, hkv, g, *q.shape[2:])
    pad = x.new_zeros((b, hkv, rows - g, *q.shape[2:]))
    return torch.cat([x, pad], dim=2).reshape(b, hkv * rows, *q.shape[2:])


def unpad_group(x: torch.Tensor, hkv: int, group: int) -> torch.Tensor:
    """x (batch, hkv * rows, ...) -> (batch, hkv * group, ...): the first
    `group` rows of each kv head's block (x itself when rows == group)."""
    b, n = x.shape[:2]
    rows = n // hkv
    if rows == group:
        return x
    return x.reshape(b, hkv, rows, *x.shape[2:])[:, :, :group].reshape(
        b, hkv * group, *x.shape[2:])
