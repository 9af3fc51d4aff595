"""Tile geometry of the port's Hopper kernels, and the choices made at run time.

The tile sizes are the single source of the kernels' tiles: the build
(`_build.py`) passes them to nvcc as -D defines, and each kernel refuses to
compile without them. They are a first, simple choice for sm_90a, not a
tuned table: a later change sets them from H100 measurements. The TPU
package's `_DISPATCH` tables were tuned for v5e VMEM and do not carry over.

What the flash kernels can vary at run time, with no new instance, is a
`FlashConfig` (the port of JAX's, `tiny_flash_attention_tpu/ops/configs.py`):
its defaults are today's choices (`default_config`), and
`utils/autotune.py` measures the others.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TileConfig:
    block_m: int   # q rows per tile
    block_n: int   # kv rows per tile
    threads: int   # threads per block


# bf16 forward (csrc/flash_fwd.cu), the Hopper design: a block of three
# warpgroups per 128-row q tile, two consumers of 64 q rows each on wgmma
# (S = Q K^T from shared memory, O += P V with P in registers) and one
# producer whose elected thread keeps TMA loads of 128-row K and V tiles in
# flight through a ring of FLASH_FWD_BF16_STAGES stages guarded by
# mbarriers. Three stages: each consumer holds two (tile j's S product is
# issued before tile j - 1's PV product), so the third keeps a load in
# flight. Shared memory: `fwd_smem_bytes`, 232,016 of a block's 232,448
# bytes at head_dim 128.
FLASH_FWD_BF16 = TileConfig(block_m=128, block_n=128, threads=384)
FLASH_FWD_BF16_STAGES = 3   # ring stages
# The wide instance (head dims in (128, 256], tiles of 256 columns): the q
# tile alone is 64 KiB and one 128-row K+V stage 128 KiB, so its kv tiles
# are 64 rows in a ring of two stages (198,216 bytes), three stages not
# fitting (256 KiB); the stage's empty barrier is split into K's and V's,
# so the K of tile j + 2 loads once tile j's softmax has read it while tile
# j + 1's S runs (csrc/flash_fwd_wgmma.cuh). O is 128 f32 registers a
# consumer thread, S 32, P 16.
FLASH_FWD_BF16_WIDE = TileConfig(block_m=128, block_n=64, threads=384)
FLASH_FWD_BF16_WIDE_STAGES = 2
# The instance of width 512 (bf16 over bf16 K/V at head dims in (256, 512],
# tiles of 512 columns): O over 512 columns would be 256 f32 registers a
# consumer thread, so its two consumers take the same 64 q rows and split
# O's columns (128 registers each, PV as m64n256k16 over its half of V),
# both computing the whole S (m64n32k16 over 32 k-steps, 16 registers). A
# 64-row q tile is 64 KiB and a 32-row K or V tile 32 KiB, so its kv tiles
# are 32 rows in a two-stage ring released apart (q 64 KiB, K/V 128 KiB:
# 197,960 bytes); 64-row kv tiles would take 192 KiB in one stage.
FLASH_FWD_BF16_512 = TileConfig(block_m=64, block_n=32, threads=384)
FLASH_FWD_BF16_512_STAGES = 2
# The bf16 forward and backward read any head_dim d that is a multiple of 8
# at its true width (ops/dims.py::flash_head_dim). With a FlashConfig's
# `narrow_products` a d in (64, 80] or (80, 96] runs the instances of width
# 80 or 96 (ops/dims.py::flash_width), whose products skip the zero columns
# of the 128-column tiles; without it, the 128-wide instance, whose
# products run over those zeros (the bits are the same: chip_smoke.py
# times both in one call, PERF.md).
# f32 forward on the CUDA cores (csrc/flash_fwd.cuh's f32 body): 256
# threads over a 128 x 64 score tile, 8 x 4 scores and 8 x D/16 outputs a
# thread; K and V stream through a two-stage cp.async ring. Where the q
# tiles give fewer than FLASH_FWD_F32_SPLIT_BELOW blocks (two waves of the
# H100's 132 SMs), each 128-row q tile's kv range is cut at the multiples
# of S kv tiles into runs, one block per (run, q head, batch), merged in
# run order by the last run of the tile to arrive: S is a FlashConfig's
# `f32_split`, or the least S above it whose runs of tiles that split need
# at most FLASH_FWD_F32_MAX_SLOTS partial slots over the batch and heads
# (ops/flash.py::fwd_f32_split; the two bounds read at each call; the merge's
# workspace stays under 1056 x 128 x 130 x 4 bytes, 70 MB, at head_dim
# 128). At the f32 train step's (1, 8, 1024) causal, 144 blocks at S 5 on
# the 132 SMs, none longer than 5 kv tiles (chip_smoke.py's sweep,
# `fwd_f32_split_sweep`, PERF.md); with enough q tiles, no split and no
# workspace. The quantized instances (csrc/flash_fwd_quant.cu, int8 or e4m3 K/V
# with per-token scales) take the tiles of their q dtype's design, the wide
# ones at head_dim 256: bf16 q the wgmma kernel's (its producer warpgroup
# converts each payload tile into the ring's bf16 stage, in the same layout
# and shared memory), f32 q the f32 body's (each payload tile loaded into
# registers a step ahead and converted into its stage). Shared memory
# (`fwd_smem_bytes`): 229,888 bytes at head_dim 128, 230,912 quantized; one
# block an SM.
FLASH_FWD_F32 = TileConfig(block_m=128, block_n=64, threads=256)
# The wide f32 instance (head dims in (128, 256], tiles of 256 columns): a
# 128-row q tile alone is 128 KiB of f32 there and two 64-row K/V stages 256
# KiB, so its q tiles are 64 rows and its kv tiles 32, in the same
# two-stage ring (q 64 KiB, K/V 128 KiB, P^T 8 KiB: 205,056 bytes); a thread
# holds S at 4 rows x 2 columns and O at 4 rows x 16 columns (64 registers,
# as the 128 instance's 8 x 8). Its runs start from as many kv columns as
# `f32_split`'s (`fwd_f32_split`); a merge slot, 64 x 258 floats,
# is about the 128 instance's 128 x 130, so FLASH_FWD_F32_MAX_SLOTS keeps
# the workspace under 70 MB at either width.
FLASH_FWD_F32_WIDE = TileConfig(block_m=64, block_n=32, threads=256)
# The f32 instance of width 512 (f32 q over f32 K/V at head dims in (256,
# 512], padded to 512): a 64-row q tile is 128 KiB of f32 there and two
# stages of 32-row K and V 256 KiB, and O over 64 rows would be 128
# registers a thread. So its q tiles are 32 rows and its kv tiles 32, K
# and V in one buffer each, released apart: K of tile t + 1 is copied
# while the softmax and the PV product of tile t run, V of tile t + 1
# while the S product of tile t + 1 runs (q 64 KiB, K 64 KiB, V 64 KiB,
# P^T 4 KiB, the ids: 200,832 bytes). Its 256 threads map 8 x 32 over
# the tile: S at 4 rows x 1 column a thread, O at 4 rows x 16 columns (64
# registers, as the other instances), a row's max and sum over one warp.
# A merge slot is 32 x 514 floats, so FLASH_FWD_F32_MAX_SLOTS slots hold
# 69.4 MB; its runs start from as many kv columns as `f32_split`'s.
FLASH_FWD_F32_512 = TileConfig(block_m=32, block_n=32, threads=256)
FLASH_FWD_F32_SPLIT_BELOW = 264
FLASH_FWD_F32_MAX_SLOTS = 1056
# Shared memory one block may use on the H100 (227 KB).
SMEM_PER_BLOCK = 232448


def fwd_smem_bytes(cfg: TileConfig, head_dim: int,
                   quantized: bool = False) -> int:
    """Dynamic shared memory of one forward block at `cfg`'s tiles over
    unquantized or quantized K/V, as the kernels lay it out (csrc/
    flash_fwd_wgmma.cuh `FwdSmem`, csrc/flash_fwd.cuh `f32_smem_bytes`).
    The libraries export their own sizes (`tfa_flash_fwd_smem`,
    `tfa_flash_fwd_quant_smem`), and ops/flash.py checks that these agree
    when it loads them."""
    m, n, d = cfg.block_m, cfg.block_n, head_dim
    if any(cfg is c for c in (FLASH_FWD_BF16, FLASH_FWD_BF16_WIDE,
                              FLASH_FWD_BF16_512)):
        stages = (FLASH_FWD_BF16_STAGES if cfg is FLASH_FWD_BF16
                  else FLASH_FWD_BF16_512_STAGES if cfg is FLASH_FWD_BF16_512
                  else FLASH_FWD_BF16_WIDE_STAGES)
        # q; per stage K, V and the kv ids; the mbarriers (q, and full K,
        # full V, empty per stage; a two-stage ring also K's empty;
        # quantized K/V, which land as payloads in the ring and expand
        # there, also the payload copies' per stage, K's and V's apart in a
        # two-stage ring); room to align the base to 1024 bytes
        split = stages == 2
        bars = 3 + split + quantized * (1 + split)
        return (m * d * 2 + stages * (2 * n * d * 2 + n * 4)
                + (1 + bars * stages) * 8 + 1024)
    if cfg is FLASH_FWD_F32 or cfg is FLASH_FWD_F32_WIDE:
        # q, two stages of K and V, P^T (kv x q), all f32; per stage the
        # kv ids and, quantized, the k and v scales
        return ((m * d + 4 * n * d + n * m) * 4
                + 2 * (3 if quantized else 1) * n * 4)
    if cfg is FLASH_FWD_F32_512 and not quantized:
        # q, one buffer of K and one of V, P^T, the kv ids (one stage)
        return (m * d + 2 * n * d + n * m + n) * 4
    raise ValueError(f"{cfg} is not a forward config "
                     f"({'quantized' if quantized else 'unquantized'} K/V)")


# paged decode (fused and separate pages), split over the kv length: one
# block of PAGED_DECODE_WARPS warps per (split, kv head, sequence); each
# warp walks 32-token chunks of its split through a ring in shared memory.
# A split holds PAGED_DECODE_SPLIT_TOKENS tokens of whole pages, counted
# from the table's first page (or the window's), and the splits cover the
# table's width (or the window): both known on the host, never the lengths,
# which live on the card. The split's size is fixed in tokens, not derived
# from the width, so a sequence's result does not depend on how wide the
# engine buckets its table (the splits past a length are empty and add
# exact zeros). At the int8 engine's 8k cells (64 pages of 128, 8
# sequences, 2 kv heads) that is 16 splits, 256 blocks, about 2 a SM of the
# H100's 132; chip_smoke.py's sweep there (`decode_split_sweep`, PERF.md)
# found 16 splits of 4 pages faster than 22 of 3 and 32 of 2.
PAGED_DECODE_WARPS = 4
# f32 pages at head_dim 256: a warp's 32-token stage of f32 K and V is 64
# KiB, so a block of four would need 256 KiB; it takes
# PAGED_DECODE_F32_WIDE_WARPS warps (196,608 bytes of rings at 3) and one
# block an SM.
PAGED_DECODE_F32_WIDE_WARPS = 3
# bf16 q over bf16 and int8 pages at head dims in (256, 512] (the instances
# of width 512): a warp's 32-token bf16 stage is 64 KiB there and its two
# int8 stages 66,048 bytes, so a block of four would need 256 KiB or more;
# it takes PAGED_DECODE_512_WARPS warps (196,608 bytes of bf16 rings,
# 198,144 of int8 at 3) and one block an SM.
PAGED_DECODE_512_WARPS = 3
PAGED_DECODE_SPLIT_TOKENS = 512


def window_pages(window: int, page_size: int) -> int:
    """The most pages `window` consecutive tokens touch."""
    return (window + page_size - 2) // page_size + 1


def paged_decode_split_pages(page_size: int) -> int:
    """Whole pages in one split of the decode."""
    return max(1, PAGED_DECODE_SPLIT_TOKENS // page_size)


def decode_split_plan(pages: int, splits: int) -> tuple[int, int]:
    """(pages a split, splits) for `splits` asked of `pages` pages: whole
    pages a split, the last split not empty."""
    per = -(-pages // max(1, splits))
    return per, -(-pages // per)


# FA1 forward (the teaching kernel, csrc/flash_v1.cu). bf16 on wgmma and
# TMA with FA1's loop order: a block of three warpgroups (two consumers of
# 64 q rows, a producer) walks the kv tiles and, inside each, its
# FLASH_V1_BF16_Q_TILES q tiles of 128 rows from the host-built schedule
# (ops/flash_v1.py::v1_schedule); K and V stream through a ring of
# FLASH_V1_BF16_STAGES stages, the q tiles of the inner loop through a ring
# of as many of their own. Two K/V stages let tile j + 1 land while tile
# j's q tiles are walked; a third does not fit beside two q stages
# (`v1_smem_bytes`: 197,712 bytes at head_dim 128). Two q tiles a block:
# 128 blocks at the benchmark's (2, 8, 2048) shape on 132 SMs.
FLASH_V1_BF16 = TileConfig(block_m=128, block_n=128, threads=384)
FLASH_V1_BF16_STAGES = 2
FLASH_V1_BF16_Q_TILES = 2
# The wide instance (head dims in (128, 256], tiles of 256 columns): a
# 128-row q tile is 64 KiB there and a 128-row K+V stage 128 KiB, so at the
# tiles above a block would need 394,320 bytes; its kv tiles are 64 rows
# (S 32 f32 registers a consumer thread beside O's 128, as B1's wide
# instance), K and V in FLASH_V1_BF16_WIDE_KV_STAGES stages and the q tile
# in FLASH_V1_BF16_WIDE_Q_STAGES (197,696 bytes), the same q tiles a block.
FLASH_V1_BF16_WIDE = TileConfig(block_m=128, block_n=64, threads=384)
FLASH_V1_BF16_WIDE_Q_STAGES = 1
FLASH_V1_BF16_WIDE_KV_STAGES = 2
# f32 on the CUDA cores with FA1's order kept: a block of 17 warps takes
# FLASH_V1_F32_Q_TILES 64-row q tiles from the same schedule at 64-row tiles
# (128 blocks at the benchmark's (2, 8, 1024) on 132 SMs) and splits each
# (kv tile, q tile) step by role: two S groups of 128 threads (8 x 4 score
# tiles) take the steps in turn, a PV group of 256 (8 x 4 output tiles)
# merges every step into the reloaded state, a loader warp streams K and q
# by cp.async. Shared memory (`v1_smem_bytes`): 230,496 bytes at head_dim
# 128, one block an SM.
FLASH_V1_F32 = TileConfig(block_m=64, block_n=64, threads=544)
FLASH_V1_F32_Q_TILES = 2
# The wide f32 instance (head dims in (128, 256]): at 64 x 64 a block would
# need 427,104 bytes, so its q and kv tiles are 32 rows (205,408 bytes); the
# roles keep their threads, an S thread holding 4 x 2 scores and a PV
# thread 8 rows x 4 columns of O (32 x 256), the same q tiles a block.
FLASH_V1_F32_WIDE = TileConfig(block_m=32, block_n=32, threads=544)


def v1_smem_bytes(cfg: TileConfig, head_dim: int) -> int:
    """Dynamic shared memory of one FA1 block at `cfg`'s tiles, as the
    kernels lay it out (csrc/flash_v1.cu `V1Smem` and `V1F32Smem`;
    the library exports its own sizes, `tfa_flash_v1_smem`, and
    ops/flash_v1.py checks that these agree when it loads it)."""
    m, n, d = cfg.block_m, cfg.block_n, head_dim
    if cfg is FLASH_V1_BF16 or cfg is FLASH_V1_BF16_WIDE:
        q_stages, kv_stages = (
            (FLASH_V1_BF16_STAGES, FLASH_V1_BF16_STAGES)
            if cfg is FLASH_V1_BF16 else
            (FLASH_V1_BF16_WIDE_Q_STAGES, FLASH_V1_BF16_WIDE_KV_STAGES))
        # per q stage a q tile and two mbarriers (full, empty), per K/V
        # stage K, V and three (K full, V full, K/V empty); room to align
        # the base to 1024 bytes
        return (q_stages * (m * d * 2 + 2 * 8)
                + kv_stages * (2 * n * d * 2 + 3 * 8) + 1024)
    if cfg is FLASH_V1_F32 or cfg is FLASH_V1_F32_WIDE:
        # two-stage K and V rings, a q tile and a p'^T tile (kv x q) per S
        # group and its rows' (max, sum), all f32; six pairs of mbarriers
        return (4 * n * d + 2 * m * d + 2 * n * m + 4 * m) * 4 + 12 * 8
    raise ValueError(f"{cfg} is not an FA1 config")
# bf16 backward, one pass: a block of two warpgroups owns a 128-row kv tile
# (64 rows each, dk and dv in f32 registers: 2 x 64 per thread at head_dim
# 128) and steps over 64-row q tiles that TMA streams through a two-stage
# ring (K, V, two stages of q, qs and dout, dS^T and the dQ staging: 211 KB
# of shared memory at head_dim 128). The kernel is written for these sizes.
FLASH_BWD_BF16 = TileConfig(block_m=64, block_n=128, threads=256)
# The wide instance (head dims in (128, 256]): one block per 64-row kv
# tile, its two warpgroups splitting the head dim of dK and dV (64 + 64
# f32 registers a thread, where 64 x 256 of both would be 256) and the q
# columns of S^T and dP^T; one stage of q, qs and dout (96 KiB) beside K
# and V (64 KiB), P^T and two dS^T tiles: 190,528 bytes (csrc/flash_bwd.cu,
# the wide kernel).
FLASH_BWD_BF16_WIDE = TileConfig(block_m=64, block_n=64, threads=256)
# The instance of width 512 (head dims in (256, 512]): a 64-row kv tile's dK
# and dV at 512 columns would fill the register file, and a 64-row q stage
# beside K and V would need more than 320 KiB. So two blocks take each
# (64-row kv tile, q head), one for each 256-column half of dK, dV and dQ
# (64 + 64 f32 registers a thread, as in the wide instance), both
# recomputing S^T and dP^T over all 512 columns; the q steps are 32 rows:
# K, V, one stage of qs and dout (whole rows) and of q (the half's
# columns), P and two dS tiles, 227,392 bytes (csrc/flash_bwd.cu,
# flash_bwd_512_kernel).
FLASH_BWD_BF16_512 = TileConfig(block_m=32, block_n=64, threads=256)


def bwd_config(head_dim: int) -> TileConfig:
    """The bf16 backward's tiles at the tiles' head_dim (64, 128, 256 or
    512)."""
    if head_dim > 256:
        return FLASH_BWD_BF16_512
    return FLASH_BWD_BF16_WIDE if head_dim > 128 else FLASH_BWD_BF16


def bwd_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one bf16 backward main block at the tiles'
    head_dim, as csrc/flash_bwd.cu lays it out (`Smem`, `WideSmem`,
    `Smem512`; the library exports its own, `tfa_flash_bwd_bf16_smem`,
    and ops/flash_bwd.py checks that they agree when it loads it)."""
    d = head_dim
    if head_dim > 256:
        m, n = FLASH_BWD_BF16_512.block_m, FLASH_BWD_BF16_512.block_n
        qt = m * d * 2
        # K, V; qs and dout (whole rows), q (half of them), the rows (a
        # kilobyte); P and two dS (bf16, m x n); three mbarriers in 64 bytes
        return 2 * n * d * 2 + 2 * qt + qt // 2 + 1024 + 3 * n * m * 2 \
            + 64 + 1024
    m = FLASH_BWD_BF16.block_m
    qt, rows = m * d * 2, 3 * m * 4
    if head_dim > 128:
        n = FLASH_BWD_BF16_WIDE.block_n
        # K, V; qs, q, dout and the rows (a kilobyte); P^T and two dS^T
        # (bf16, n x m); three mbarriers in 64 bytes
        return 2 * n * d * 2 + 3 * qt + 1024 + 3 * n * m * 2 + 64 + 1024
    n = FLASH_BWD_BF16.block_n
    stage = -(-(3 * qt + rows) // 1024) * 1024
    # K, V; two stages; dS^T (bf16, n x m); the dQ staging (2 x m x 64
    # f32); the mbarriers in 64 bytes
    return 2 * n * d * 2 + 2 * stage + n * m * 2 + 2 * m * 64 * 4 + 64 + 1024
# f32 backward on the CUDA cores (csrc/flash_bwd.cu's f32 path): 64-row
# tiles on both sides, blocks of two halves of 128 threads; a dk/dv block
# takes one kv tile and a run of the q tiles that see it, cut at the
# multiples of FLASH_BWD_F32_SPLIT (read at each call), for one q head (a
# dq block the same, q-major), so the causal band's long ranges split over
# blocks: 192 a kernel at (1, 8, 1024) causal on the 132 SMs, where one
# block a (kv tile, kv head) gave 32. chip_smoke.py's sweep
# (`bwd_f32_split_sweep`, PERF.md) found runs of 8 tiles faster than 1, 2,
# 3, 4, 6 and 16 there. Shared memory (`bwd_f32_smem_bytes`): 231,680
# bytes at head_dim 128, one block an SM.
FLASH_BWD_F32 = TileConfig(block_m=64, block_n=64, threads=256)
FLASH_BWD_F32_SPLIT = 8
# The wide f32 instances (head dims in (128, 256]): two 64-row tiles that
# stay are 128 KiB of f32 at 256 and one stage of two more as much, so the
# tiles are 32 rows on both sides in the same two-stage ring (205,952
# bytes); a half's dK or dV is 4 rows x 16 columns a thread (64 registers,
# as at 128), dQ's 256 threads split its columns in two halves of 128. Runs
# hold as many rows as FLASH_BWD_F32_SPLIT's (`bwd_f32_split`).
FLASH_BWD_F32_WIDE = TileConfig(block_m=32, block_n=32, threads=256)


def bwd_f32_config(head_dim: int) -> TileConfig:
    """The f32 backward's tiles at the tiles' head_dim (64, 128 or 256)."""
    return FLASH_BWD_F32_WIDE if head_dim > 128 else FLASH_BWD_F32


def bwd_f32_split(head_dim: int) -> int:
    """The f32 backward's run length in tiles at head_dim: the rows of
    FLASH_BWD_F32_SPLIT (read at each call) tiles of FLASH_BWD_F32."""
    return (FLASH_BWD_F32_SPLIT * FLASH_BWD_F32.block_m
            // bwd_f32_config(head_dim).block_m)


def bwd_f32_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one f32 backward block (both kernels), as
    csrc/flash_bwd.cu `F32Smem` lays it out (the library exports its own,
    `tfa_flash_bwd_f32_smem`, and ops/flash_bwd.py checks that they agree
    when it loads it): two tiles that stay, a two-stage ring of two tiles,
    the P and dS score tiles, and nine rows of a tile (LSE, delta and ids
    for each stage and for the tiles that stay), all f32 or int32."""
    t, d = bwd_f32_config(head_dim).block_m, head_dim
    return (6 * t * d + 2 * t * t + 9 * t) * 4
# weight-only quantized matmul, bf16 x (csrc/quant_matmul.cu, on the
# tensor cores): a block of 4 warps walks tiles of 128 output columns over
# its slice of K; the weight streams through a ring of QUANT_MATMUL_STAGES
# stages of QUANT_MATMUL_K_STAGE rows x 128 bytes in shared memory (16 rows
# a warp); block_m is the most rows the kernel takes (two 8-row B tiles of
# mma.sync m16n8k16).
QUANT_MATMUL_TC = TileConfig(block_m=16, block_n=128, threads=128)
QUANT_MATMUL_K_STAGE = 64
QUANT_MATMUL_STAGES = 4
# f32 x keeps the CUDA-core body (the tensor cores would round f32 x to
# TF32): a block owns 32 output columns and a slice of K; its 8 warps split
# the slice (4 column groups of 8 per warp row, 8 k rows per warp step); x
# is staged in 512-column chunks of f32 in shared memory.
QUANT_MATMUL = TileConfig(block_m=16, block_n=32, threads=256)
QUANT_MATMUL_K_CHUNK = 512
# K slices of one call (the blocks of a thread block cluster, at most 8):
# enough that the column tiles times the slices fill about
# QUANT_MATMUL_TARGET_BLOCKS blocks, never below QUANT_MATMUL_MIN_SPLIT_ROWS
# k rows a block (two stages), and enough that x's slice fits in shared
# memory (QUANT_MATMUL_X_BYTES, bf16). The H100 sweep of chip_smoke.py
# (`qmm_split_sweep`, the times in PERF.md) checks the choice.
QUANT_MATMUL_MAX_SPLITS = 8
QUANT_MATMUL_TARGET_BLOCKS = 132
QUANT_MATMUL_MIN_SPLIT_ROWS = 128
QUANT_MATMUL_X_BYTES = 128 * 1024


def quant_matmul_splits(n: int, k: int, rows: int = 8) -> int:
    """K slices for a quantized matmul of N columns, depth K and `rows`
    rows of x."""
    tiles = -(-n // QUANT_MATMUL_TC.block_n)
    want = min(QUANT_MATMUL_MAX_SPLITS, k // QUANT_MATMUL_MIN_SPLIT_ROWS,
               -(-QUANT_MATMUL_TARGET_BLOCKS // tiles))
    rows = 8 if rows <= 8 else 16
    fit = -(-rows * k * 2 // QUANT_MATMUL_X_BYTES)
    splits = max(1, want, min(fit, QUANT_MATMUL_MAX_SPLITS, k))
    # the kernel's slices are whole stages: the count it launches
    stage = QUANT_MATMUL_K_STAGE
    per = -(-k // splits)
    per = -(-per // stage) * stage
    return -(-k // per)


# quantized_matmul's route on the card: the kernel up to this many
# activation rows (decode: B x 1), the cuBLAS product on the converted
# payload above (prefill). Set from chip_smoke.py's row sweep on the H100
# (the times are in PERF.md): up to 8 rows the kernel is the faster at
# every engine projection; the tensor-core kernel also wins at 16 rows,
# which no engine path has measured end to end, so the route stays.
QUANT_MATMUL_MAX_ROWS = 8


def _tile_defines(prefix: str, cfg: TileConfig) -> list[str]:
    return [f"-D{prefix}_BLOCK_M={cfg.block_m}",
            f"-D{prefix}_BLOCK_N={cfg.block_n}",
            f"-D{prefix}_THREADS={cfg.threads}"]


def nvcc_defines() -> list[str]:
    """The -D flags every kernel source is compiled with."""
    return [
        *_tile_defines("TFA_FWD_BF16", FLASH_FWD_BF16),
        f"-DTFA_FWD_BF16_STAGES={FLASH_FWD_BF16_STAGES}",
        *_tile_defines("TFA_FWD_BF16_WIDE", FLASH_FWD_BF16_WIDE),
        f"-DTFA_FWD_BF16_WIDE_STAGES={FLASH_FWD_BF16_WIDE_STAGES}",
        *_tile_defines("TFA_FWD_BF16_512", FLASH_FWD_BF16_512),
        f"-DTFA_FWD_BF16_512_STAGES={FLASH_FWD_BF16_512_STAGES}",
        *_tile_defines("TFA_FWD_F32", FLASH_FWD_F32),
        *_tile_defines("TFA_FWD_F32_WIDE", FLASH_FWD_F32_WIDE),
        *_tile_defines("TFA_FWD_F32_512", FLASH_FWD_F32_512),
        *_tile_defines("TFA_BWD_BF16", FLASH_BWD_BF16),
        *_tile_defines("TFA_BWD_BF16_WIDE", FLASH_BWD_BF16_WIDE),
        *_tile_defines("TFA_BWD_BF16_512", FLASH_BWD_BF16_512),
        *_tile_defines("TFA_BWD_F32", FLASH_BWD_F32),
        *_tile_defines("TFA_BWD_F32_WIDE", FLASH_BWD_F32_WIDE),
        *_tile_defines("TFA_QMM", QUANT_MATMUL),
        f"-DTFA_QMM_K_CHUNK={QUANT_MATMUL_K_CHUNK}",
        f"-DTFA_QMM_TC_BLOCK_N={QUANT_MATMUL_TC.block_n}",
        f"-DTFA_QMM_TC_THREADS={QUANT_MATMUL_TC.threads}",
        f"-DTFA_QMM_TC_K_STAGE={QUANT_MATMUL_K_STAGE}",
        f"-DTFA_QMM_TC_STAGES={QUANT_MATMUL_STAGES}",
        f"-DTFA_DECODE_WARPS={PAGED_DECODE_WARPS}",
        f"-DTFA_DECODE_F32_WIDE_WARPS={PAGED_DECODE_F32_WIDE_WARPS}",
        f"-DTFA_DECODE_512_WARPS={PAGED_DECODE_512_WARPS}",
        *_tile_defines("TFA_V1_BF16", FLASH_V1_BF16),
        f"-DTFA_V1_BF16_STAGES={FLASH_V1_BF16_STAGES}",
        f"-DTFA_V1_BF16_Q_TILES={FLASH_V1_BF16_Q_TILES}",
        *_tile_defines("TFA_V1_BF16_WIDE", FLASH_V1_BF16_WIDE),
        f"-DTFA_V1_BF16_WIDE_Q_STAGES={FLASH_V1_BF16_WIDE_Q_STAGES}",
        f"-DTFA_V1_BF16_WIDE_KV_STAGES={FLASH_V1_BF16_WIDE_KV_STAGES}",
        *_tile_defines("TFA_V1_F32", FLASH_V1_F32),
        f"-DTFA_V1_F32_Q_TILES={FLASH_V1_F32_Q_TILES}",
        *_tile_defines("TFA_V1_F32_WIDE", FLASH_V1_F32_WIDE),
    ]


# --- the run-time choices of the flash kernels -------------------------------


@dataclasses.dataclass(frozen=True)
class FlashConfig:
    """What the flash kernels vary at run time (no new instance compiled):
    the `config=` of every flash entry, its defaults today's choices.

    narrow_products: bf16 over bf16 K/V at a head_dim in (64, 96] that is
      a multiple of 8 runs the n80/n96 instance (True) or the 128-wide
      one (False; the same bits, products over the zero columns).
    f32_split: the f32 forward's least run, in kv tiles of FLASH_FWD_F32
      (64 columns), where the q tiles give too few blocks
      (ops/flash.py::fwd_f32_split).

    JAX's fields map so: its `block_q` / `block_kv` / `kv_splits` tile the
    TPU's VMEM and cut the kv walk; the port's kv walk is cut by
    `f32_split` (f32), its tiles are fixed at build time (-D flags above).
    Its `kernel` / `tri_sub` / `tri_leaf` pick among the TPU's three
    forward kernels, which one Hopper kernel ports; `stats_streams`,
    `use_dimension_semantics` and `interpret` have no counterpart on this
    card. `narrow_products` is the port's own. On the CPU a config changes
    nothing: it schedules the kernels only, and the plain versions compute
    the same function whatever it says."""
    narrow_products: bool = True
    f32_split: int = 5


def default_config(dtype=None, head_dim: int = 0, q_len: int = 0,
                   kv_len: int = 0, causal: bool = True) -> FlashConfig:
    """Today's choices, FlashConfig(): a call without `config` runs them.
    The arguments are JAX's signature; no choice depends on them here, the
    f32 runs' rule taking the launch's shape itself (`fwd_f32_split`)."""
    del dtype, head_dim, q_len, kv_len, causal
    return FlashConfig()


def check_config(config) -> FlashConfig:
    """`config` if the kernels can run it; raises ValueError before any
    launch otherwise: not a FlashConfig (a JAX one names TPU tiles), a
    `narrow_products` that is not a bool, or an `f32_split` below one
    tile."""
    if not isinstance(config, FlashConfig):
        raise ValueError(f"config must be the port's FlashConfig, got "
                         f"{type(config).__name__}")
    if not isinstance(config.narrow_products, bool):
        raise ValueError(f"narrow_products must be a bool, got "
                         f"{config.narrow_products!r}")
    x = config.f32_split
    if not isinstance(x, int) or isinstance(x, bool) or x < 1:
        raise ValueError(f"f32_split must be an int >= 1, got {x!r}")
    return config


def resolve_config(config=None) -> FlashConfig:
    """The config a public entry runs: FlashConfig() for None, else the
    caller's, checked (`check_config`). Internal functions take the
    result."""
    return FlashConfig() if config is None else check_config(config)
