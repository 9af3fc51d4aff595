"""Tile geometry of the port's Hopper kernels.

These values are the single source of the kernels' tile sizes: the build
(`_build.py`) passes them to nvcc as -D defines, and each kernel refuses to
compile without them. They are a first, simple choice for sm_90a, not a
tuned table: a later change sets them from H100 measurements. The TPU
package's `_DISPATCH` tables were tuned for v5e VMEM and do not carry over.
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
# f32 forward on the CUDA cores: 16 x 16 threads over a 64 x 64 score tile.
FLASH_FWD_F32 = TileConfig(block_m=64, block_n=64, threads=256)
# The forward's quantized instances (csrc/flash_fwd_quant.cu, int8 or e4m3
# K/V with per-token scales) keep the mma.sync body of csrc/flash_fwd.cuh
# (4 warps x 16 q rows, 64-row kv tiles): their two-stage cp.async ring
# carries 1-byte payload rows and their f32 scales, and each landed tile is
# converted into one bf16 (or f32) staging tile of the unquantized layout,
# which wgmma could only read back from shared memory through a stage of
# its own. With bf16 q their tiles differ from the bf16 design's (64-row
# mma.sync tiles against 128-row wgmma tiles), so they take a config of
# their own; with f32 q they run the f32 body on FLASH_FWD_F32's tiles.
FLASH_FWD_QUANT_BF16 = TileConfig(block_m=64, block_n=64, threads=128)
# Shared memory one block may use on the H100 (227 KB).
SMEM_PER_BLOCK = 232448


def fwd_smem_bytes(cfg: TileConfig, head_dim: int,
                   quantized: bool = False) -> int:
    """Dynamic shared memory of one forward block at `cfg`'s tiles over
    unquantized or quantized K/V, as the kernels lay it out (csrc/
    flash_fwd.cu `FwdSmem`, csrc/flash_fwd.cuh `bf16_quant_smem_bytes` and
    `f32_smem_bytes`). The libraries export their own sizes
    (`tfa_flash_fwd_smem`, `tfa_flash_fwd_quant_smem`), and ops/flash.py
    checks that these agree when it loads them."""
    m, n, d = cfg.block_m, cfg.block_n, head_dim
    if cfg is FLASH_FWD_BF16 and not quantized:
        stages = FLASH_FWD_BF16_STAGES
        # q; per stage K, V and the kv ids; the mbarriers (q, and full K,
        # full V, empty per stage); room to align the base to 1024 bytes
        return (m * d * 2 + stages * (2 * n * d * 2 + n * 4)
                + (1 + 3 * stages) * 8 + 1024)
    if cfg is FLASH_FWD_QUANT_BF16 and quantized:
        # q and one converted K and V tile (rows padded by 8 bf16), a
        # two-stage ring of payload rows with their k and v scales, the ids
        return 3 * m * (d + 8) * 2 + 2 * n * (2 * d + 2 * 4) + 2 * n * 4
    if cfg is FLASH_FWD_F32:
        # q^T, k^T, v, p (rows padded by 1) and the kv ids; quantized: the
        # tile's k and v scales
        return ((d * m + d * n + n * d + m * (n + 1)) * 4 + n * 4
                + (2 * n * 4 if quantized else 0))
    raise ValueError(f"{cfg} is not a forward config "
                     f"({'quantized' if quantized else 'unquantized'} K/V)")


# paged decode (fused and separate pages): one block per (kv head,
# sequence); warps split the sequence into 32-token chunks.
PAGED_DECODE_WARPS = 8
# FA1 forward (the teaching kernel): the mma.sync tiles (bf16: 4 warps x 16
# q rows on mma.sync, K and V of one 64-row kv tile in 35 KB of shared
# memory; f32: 16 x 16 threads over a 64 x 64 score tile); a block walks
# FLASH_V1_Q_TILES q tiles of one head (interleaved) inside each kv step.
FLASH_V1_BF16 = TileConfig(block_m=64, block_n=64, threads=128)
FLASH_V1_F32 = TileConfig(block_m=64, block_n=64, threads=256)
FLASH_V1_Q_TILES = 4
# bf16 backward, one pass: a block of two warpgroups owns a 128-row kv tile
# (64 rows each, dk and dv in f32 registers: 2 x 64 per thread at head_dim
# 128) and steps over 64-row q tiles that TMA streams through a two-stage
# ring (K, V, two stages of q, qs and dout, dS^T and the dQ staging: 211 KB
# of shared memory at head_dim 128). The kernel is written for these sizes.
FLASH_BWD_BF16 = TileConfig(block_m=64, block_n=128, threads=256)
# f32 backward, both kernels: 16 x 16 threads over a 64 x 64 score tile.
FLASH_BWD_F32 = TileConfig(block_m=64, block_n=64, threads=256)
# weight-only quantized matmul: a block owns 32 output columns and a slice
# of K; its 8 warps split the slice (4 column groups of 8 per warp row, 8 k
# rows per warp step); x is staged in 512-column chunks of f32 in shared
# memory. block_m is the most rows the kernel takes (x rows in shared
# memory, 8 f32 accumulators per row per thread).
QUANT_MATMUL = TileConfig(block_m=16, block_n=32, threads=256)
QUANT_MATMUL_K_CHUNK = 512
# K slices of one call (the blocks of a thread block cluster, at most 8),
# set from chip_smoke.py's split sweep on the H100 (the times are in
# PERF.md): only where N gives fewer than 66 column blocks (wq/wo, wk/wv,
# w_down of the engine model), up to about 128 blocks in all, and never
# below 512 k rows a block; w_gate/w_up and the lm_head are slower sliced.
QUANT_MATMUL_MAX_SPLITS = 8
QUANT_MATMUL_SPLIT_BELOW_BLOCKS = 66
QUANT_MATMUL_TARGET_BLOCKS = 128
QUANT_MATMUL_MIN_SPLIT_ROWS = 512


def quant_matmul_splits(n: int, k: int) -> int:
    """K slices for a quantized matmul of N columns and depth K."""
    blocks = -(-n // QUANT_MATMUL.block_n)
    if blocks >= QUANT_MATMUL_SPLIT_BELOW_BLOCKS:
        return 1
    return max(1, min(QUANT_MATMUL_MAX_SPLITS,
                      k // QUANT_MATMUL_MIN_SPLIT_ROWS,
                      -(-QUANT_MATMUL_TARGET_BLOCKS // blocks)))


# quantized_matmul's route on the card: the kernel up to this many
# activation rows (decode: B x 1), the cuBLAS product on the converted
# payload above (prefill). Set from chip_smoke.py's row sweep on the H100
# (the times are in PERF.md): up to 8 rows the kernel is the faster at
# every engine projection, at 16 rows the route wins at w_down (K 4096).
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
        *_tile_defines("TFA_FWD_F32", FLASH_FWD_F32),
        *_tile_defines("TFA_FWDQ_BF16", FLASH_FWD_QUANT_BF16),
        *_tile_defines("TFA_BWD_BF16", FLASH_BWD_BF16),
        *_tile_defines("TFA_BWD_F32", FLASH_BWD_F32),
        *_tile_defines("TFA_QMM", QUANT_MATMUL),
        f"-DTFA_QMM_K_CHUNK={QUANT_MATMUL_K_CHUNK}",
        f"-DTFA_DECODE_WARPS={PAGED_DECODE_WARPS}",
        *_tile_defines("TFA_V1_BF16", FLASH_V1_BF16),
        *_tile_defines("TFA_V1_F32", FLASH_V1_F32),
        f"-DTFA_V1_Q_TILES={FLASH_V1_Q_TILES}",
    ]
