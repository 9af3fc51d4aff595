"""Head dims and GQA groups the kernels do not compile, as padding around them.

The JAX package takes any head_dim and any group: its forward and backward
pad head_dim to whole 128-lane tiles with zero columns
(tiny_flash_attention_tpu/ops/flash.py:423-431, ops/flash_bwd.py:478-493),
its decodes pad the q rows of a kv head to a multiple of 8
(ops/paged_fused.py:503-506, ops/paged.py:287), and each slices the result
back. The port's kernels compile a few instances (the flash kernels' tiles
of 64, 128 and 256 columns: the forward over K/V in q's dtype and over
int8/e4m3 K/V, the backward and FA1, each in bf16 and f32; the decodes
groups 1, 2, 4 and 8), so the wrappers do the same with these plain
functions where a kernel cannot read the true shape in place:

- `flash_head_dim`: the one rule. The bf16 forward over bf16 K/V and the
  bf16 backward read and write any head_dim that is a multiple of 8 up to
  512 at its true width (`reads_in_place`; above 256 their instances of
  width 512): their tensor maps land zeros past column d and their
  epilogues store only the columns below d, so they are handed the tensors
  as they are. Every other head_dim (not a multiple of 8: a tensor map's
  row stride is whole 16-byte pieces) is padded to `kernel_head_dim` up to
  256 and to 512 above, and so is every head_dim of the f32 forward and
  backward, of the quantized forward (int8/e4m3 K/V, bf16 and f32 q) and
  of FA1 (bf16 and f32): to 64, 128 or 256. Above 256 f32, the quantized
  forward and FA1 raise, each naming its own ROADMAP queue (B-dims-2a-f32,
  B-dims-2a-quant-v1), and above 512 every entry raises (B-dims-2a-512+).
- `kernel_head_dim` / `pad_head_dim` / `unpad_head_dim`: zero columns up to
  the next tile width, 64 below it, 128 up to it, 256 above (the wide
  instances). A zero column adds
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
  lane, over the 255 registers a thread may use at head_dim 128 (the top
  is 4 above head_dim 128 and 2 above 256).
- `decode_head_dim` / `decode_compiled` / `decode_width`: the decodes and
  the append read pages in place (the pages are the cache: never padded)
  at every head_dim in [1, 512] (the decodes with f32 q up to 256). 64, 80,
  96, 128, 256 and 512 have instances of their own (the decodes' at page
  size 16 or a multiple of 32, whose chunks' rows of one page are whole
  bulk copies); every other head_dim and page size runs on the run-time
  width instances of width 64, 128, 256 or 512, which read rows of the
  true width and score zeros past it.

A head_dim that is already an instance is passed through without a copy.
`pad_head_dim.copies` counts the copies it makes, so a caller (the card
tests, chip_smoke.py) can show that a path copies nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the flash kernels' tile widths (forward, backward, FA1), the wide
# instances' (every flash kernel, bf16 and f32), and the width of the bf16
# forward's (over bf16 K/V) and backward's instances above 256
FLASH_HEAD_DIMS = (64, 128)
WIDE_HEAD_DIM = 256
WIDER_HEAD_DIM = 512
# head dims the decode and append kernels compile at their own width, the
# widths of the decodes' run-time width instances (each reads any head_dim
# up to it), and the q rows a kv head that the decodes compile
DECODE_HEAD_DIMS = (64, 80, 96, 128, 256, 512)
DECODE_WIDTHS = (64, 128, 256, 512)
DECODE_GROUPS = (1, 2, 4, 8)
# the most q rows a kv head the decodes compile above head_dim 256 (the
# instances of width 512), set by their ptxas spill report: a G = 4
# instance spilled 20-25 KB a thread (compiled width) and 1.7 KB (run-time
# width, int8 pages), G = 2 none (PERF.md)
DECODE_TOP_512 = 2
# ROADMAP.md's queues of what still raises: head dims in (256, 512] in f32
# (B1, the backward, the decodes) and in the quantized forward and FA1;
# every head_dim above 512
QUEUE_F32 = "B-dims-2a-f32"
QUEUE_QUANT_V1 = "B-dims-2a-quant-v1"
QUEUE_ABOVE_512 = "B-dims-2a-512+"


def _refuse(d: int, what: str, top: int, queue: str, padded: str = ""):
    """The NotImplementedError of a head_dim d above `top`, the most that
    `what` takes: naming `queue` up to 512, QUEUE_ABOVE_512 above."""
    left = QUEUE_ABOVE_512 if d > WIDER_HEAD_DIM else queue
    return NotImplementedError(
        f"head_dim {d}: {what} takes head_dim up to {top}{padded}; "
        f"ROADMAP queue {left}")


def kernel_head_dim(d: int, what: str, *, wide: bool = False,
                    queue: str = QUEUE_QUANT_V1) -> int:
    """The flash kernels' head_dim that serves d: 64 for d <= 64, 128 for
    d <= 128, and with `wide` (the instances that have one) 256 for d <=
    256. Raises NotImplementedError above, naming `what` (the kernel), what
    it takes and `queue` (QUEUE_ABOVE_512 above 512)."""
    widths = (*FLASH_HEAD_DIMS, WIDE_HEAD_DIM) if wide else FLASH_HEAD_DIMS
    for dk in widths:
        if 0 < d <= dk:
            return dk
    raise _refuse(d, what, widths[-1], queue,
                  f" (padded to {' or '.join(map(str, widths))})")


def reads_in_place(d: int) -> bool:
    """Whether the bf16 forward kernel over bf16 K/V and the bf16 backward
    take head_dim d at its true width: a multiple of 8 (rows of whole
    16-byte pieces, a tensor map's stride) up to 512."""
    return 0 < d <= WIDER_HEAD_DIM and d % 8 == 0


def flash_width(d: int, narrow: bool) -> int:
    """The instance the bf16 forward and backward run for a head_dim d
    read in place, as csrc/hopper.cuh::flash_width picks it: 64 up to 64;
    with `narrow` (a FlashConfig's `narrow_products`) 80 or 96 up to them;
    128 up to 128; 256 up to 256; 512 above; 0 where d is not read in
    place."""
    if not reads_in_place(d):
        return 0
    if d <= 64:
        return 64
    if narrow and d <= 96:
        return 80 if d <= 80 else 96
    return 128 if d <= 128 else 256 if d <= 256 else 512


def flash_head_dim(d: int, dtype: torch.dtype, what: str, *,
                   quantized: bool = False) -> int:
    """The head_dim a flash forward or backward kernel is handed for
    tensors of head_dim d: d itself where it reads them in place (bf16,
    over bf16 K/V in the forward, `reads_in_place`: up to 512), else the
    width they are padded to (d not a multiple of 8: `kernel_head_dim(d)`,
    512 above 256; f32 and quantized K/V, 64, 128 or 256). Raises
    NotImplementedError where no kernel takes d, naming `what` and the
    ROADMAP queue: above 256 f32 (QUEUE_F32) and quantized K/V
    (QUEUE_QUANT_V1); above 512 everything."""
    if quantized:
        return kernel_head_dim(d, f"{what} over int8/e4m3 K/V", wide=True,
                               queue=QUEUE_QUANT_V1)
    if dtype != torch.bfloat16:
        return kernel_head_dim(d, f"{what} in {str(dtype).split('.')[-1]}",
                               wide=True, queue=QUEUE_F32)
    if d > WIDER_HEAD_DIM:
        raise _refuse(d, what, WIDER_HEAD_DIM, QUEUE_ABOVE_512)
    if reads_in_place(d):
        return d
    return kernel_head_dim(d, what, wide=True) if d <= WIDE_HEAD_DIM \
        else WIDER_HEAD_DIM


def pad_head_dim(x: torch.Tensor, dk: int) -> torch.Tensor:
    """x (..., d) with dk - d zero columns appended (x itself when d ==
    dk). One-byte payloads (int8, e4m3) pad with code 0 through a byte
    view: both codes are exact zeros. Each copy adds one to
    `pad_head_dim.copies`."""
    d = x.shape[-1]
    if d == dk:
        return x
    pad_head_dim.copies += 1
    if x.element_size() == 1:
        return F.pad(x.view(torch.uint8), (0, dk - d)).view(x.dtype)
    return F.pad(x, (0, dk - d))


pad_head_dim.copies = 0


def unpad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """The first d columns of x, contiguous (x itself when it has d)."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def decode_head_dim(d: int, what: str) -> None:
    """Raises NotImplementedError where the decode and append kernels take
    no head_dim d (their pages are read in place, so they are never
    padded): above 512 (ROADMAP queue B-dims-2a-512+). The append takes
    every page format to 512, the decodes q in bf16 to 512 and in f32 to
    256 (`decode_q_head_dim`): f32 pages at widths above 128, whose
    32-token stage is 64 KiB a warp, run on blocks of fewer warps
    (ops/configs.py::PAGED_DECODE_F32_WIDE_WARPS), and so do bf16 and int8
    pages above 256 (PAGED_DECODE_512_WARPS)."""
    if not 0 < d <= WIDER_HEAD_DIM:
        raise _refuse(d, what, WIDER_HEAD_DIM, QUEUE_ABOVE_512,
                      " (the pages are read in place, never padded)")


def decode_q_head_dim(d: int, dtype: torch.dtype) -> None:
    """`decode_head_dim` for the decodes with q of `dtype`, which pick
    their source by it: above 256 only bf16 q has instances (those of
    width 512); f32 q raises there, naming queue B-dims-2a-f32."""
    decode_head_dim(d, "the CUDA decode kernel")
    if dtype != torch.bfloat16 and d > WIDE_HEAD_DIM:
        raise _refuse(d, f"the CUDA decode kernel with "
                      f"{str(dtype).split('.')[-1]} q", WIDE_HEAD_DIM,
                      QUEUE_F32)


def decode_compiled(d: int, page_size: int) -> bool:
    """Whether the decodes read head_dim d at page_size on an instance of
    d's own (the compiled widths: csrc/paged_decode.cu, at 512
    csrc/paged_decode_wide.cu): d in DECODE_HEAD_DIMS and a page size of
    16 or a multiple of 32; else on a run-time width instance
    (csrc/paged_decode_widths.cu, above 256 paged_decode_wide.cu). Raises
    as decode_head_dim above 512."""
    decode_head_dim(d, "the CUDA decode kernel")
    return d in DECODE_HEAD_DIMS and (page_size == 16
                                      or page_size % 32 == 0)


def decode_width(d: int, page_size: int) -> int:
    """The width of the decode instance that reads head_dim d at page_size,
    as csrc/paged_decode.cuh::decode_width picks it: d itself on the
    compiled widths (`decode_compiled`), else the least of DECODE_WIDTHS
    that holds d."""
    if decode_compiled(d, page_size):
        return d
    return next(w for w in DECODE_WIDTHS if d <= w)


def decode_group(group: int, d: int = 128) -> tuple[int, int]:
    """(G, blocks): the decode instance's q rows a kv head and the row
    blocks that cover `group` q heads a kv head, G * blocks >= group: the
    least compiled G up to the top, else ceil(group / top) blocks of the
    top. The top is 8, 4 at head dims above 128 (the instances of width
    256) and DECODE_TOP_512 above 256: at 256 a G = 8 instance (64 PV
    accumulators and 64 scores a lane) spilled 28 KB a thread and ran 10x
    slower on the H100 than two row blocks of 4 over the same pages, the
    second reading them from L2 (PERF.md, section 6); at 512 a lane holds
    16 PV accumulators and 8 scores a q row."""
    if group < 1:
        raise ValueError(f"group {group}")
    top = (DECODE_TOP_512 if d > WIDE_HEAD_DIM else 4 if d > 128
           else DECODE_GROUPS[-1])
    for g in DECODE_GROUPS:
        if g <= top and group <= g:
            return g, 1
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
