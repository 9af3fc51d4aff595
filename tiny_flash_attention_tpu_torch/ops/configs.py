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
# paged decode: one block per (kv head, sequence); warps split the sequence
# into 32-token chunks.
PAGED_DECODE_WARPS = 8
# bf16 backward, dq: a block of 4 warps x 16 q rows steps over 64-row kv tiles
# (q, dout and two stages of K and V: 6 x 64 x 136 bf16 = 104 KB).
FLASH_BWD_BF16_DQ = TileConfig(block_m=64, block_n=64, threads=128)
# bf16 backward, dk/dv: a block of 4 warps x 16 kv rows steps over 32-row q
# tiles; each warp holds its rows' dk and dv in f32 registers (2 x 64 per
# thread at head_dim 128), which is what keeps the q step at 32 rows.
FLASH_BWD_BF16_DKV = TileConfig(block_m=32, block_n=64, threads=128)
# f32 backward, both kernels: 16 x 16 threads over a 64 x 64 score tile.
FLASH_BWD_F32 = TileConfig(block_m=64, block_n=64, threads=256)


def _tile_defines(prefix: str, cfg: TileConfig) -> list[str]:
    return [f"-D{prefix}_BLOCK_M={cfg.block_m}",
            f"-D{prefix}_BLOCK_N={cfg.block_n}",
            f"-D{prefix}_THREADS={cfg.threads}"]


def nvcc_defines() -> list[str]:
    """The -D flags every kernel source is compiled with."""
    return [
        *_tile_defines("TFA_FWD_BF16", FLASH_FWD_BF16),
        *_tile_defines("TFA_FWD_F32", FLASH_FWD_F32),
        *_tile_defines("TFA_BWD_BF16_DQ", FLASH_BWD_BF16_DQ),
        *_tile_defines("TFA_BWD_BF16_DKV", FLASH_BWD_BF16_DKV),
        *_tile_defines("TFA_BWD_F32", FLASH_BWD_F32),
        f"-DTFA_DECODE_WARPS={PAGED_DECODE_WARPS}",
    ]
