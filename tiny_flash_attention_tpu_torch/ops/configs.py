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


# bf16 forward: a block of 4 warps x 16 q rows, mma.sync m16n8k16, 64-row kv
# tiles in a two-stage cp.async ring (5 x 64 x 136 bf16 = 87 KB of shared
# memory).
FLASH_FWD_BF16 = TileConfig(block_m=64, block_n=64, threads=128)
# f32 forward on the CUDA cores: 16 x 16 threads over a 64 x 64 score tile.
FLASH_FWD_F32 = TileConfig(block_m=64, block_n=64, threads=256)
# paged decode (fused and separate pages): one block per (kv head,
# sequence); warps split the sequence into 32-token chunks.
PAGED_DECODE_WARPS = 8
# FA1 forward (the teaching kernel): the forward's tiles (bf16: 4 warps x 16
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
        *_tile_defines("TFA_FWD_F32", FLASH_FWD_F32),
        *_tile_defines("TFA_BWD_BF16", FLASH_BWD_BF16),
        *_tile_defines("TFA_BWD_F32", FLASH_BWD_F32),
        *_tile_defines("TFA_QMM", QUANT_MATMUL),
        f"-DTFA_QMM_K_CHUNK={QUANT_MATMUL_K_CHUNK}",
        f"-DTFA_DECODE_WARPS={PAGED_DECODE_WARPS}",
        *_tile_defines("TFA_V1_BF16", FLASH_V1_BF16),
        *_tile_defines("TFA_V1_F32", FLASH_V1_F32),
        f"-DTFA_V1_Q_TILES={FLASH_V1_Q_TILES}",
    ]
