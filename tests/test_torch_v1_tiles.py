"""The FA1 kernel's host-side design, on the CPU: its q-tile schedule and
the shared-memory budgets of the redesigned kernels.

  * `kv_tile_counts`, the kv tiles [0, hi) each 128-row q tile visits (the
    kernel counts them the same way, csrc/flash_common.cuh::kv_tiles),
    against a numpy count of the (q tile, kv tile) pairs that hold a
    visible (row, column) pair, a q tile that sees nothing visiting one;
  * `v1_schedule` deals every q tile to one block exactly once, and the
    blocks' kv steps even out (snake order, longest first);
  * the same at the f32 kernel's 64-row tiles and two q tiles a block:
    every q tile once, the causal work even, at least 128 blocks at the
    benchmark's (2, 8, 1024);
  * `v1_state_floats` sizes the scratch of the running state, for both
    dtypes' slot layouts;
  * `v1_smem_bytes` (FA1) and `bwd_f32_smem_bytes` (the f32 backward),
    which the libraries' own sizes are held to when they load on the card,
    fit a block's 227 KB at head_dim 64 and 128.
"""

import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_V1_BF16, FLASH_V1_BF16_Q_TILES, FLASH_V1_BF16_STAGES, FLASH_V1_F32,
    FLASH_V1_F32_Q_TILES, SMEM_PER_BLOCK, bwd_f32_smem_bytes, v1_smem_bytes)
from tiny_flash_attention_tpu_torch.ops.flash import visible_mask
from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
    kv_tile_counts, v1_config, v1_schedule, v1_state_floats)

BM, BN = FLASH_V1_BF16.block_m, FLASH_V1_BF16.block_n

# (q_len, kv_len, causal): the benchmark shape, the tile edges, the decode
# offset, q tiles no kv tile reaches, odd counts of tiles
SHAPES = [(2048, 2048, True), (2048, 2048, False), (127, 127, True),
          (128, 129, True), (129, 128, True), (255, 257, True),
          (257, 255, False), (100, 333, True), (300, 100, True),
          (1000, 130, True), (700, 700, False), (1, 2100, True),
          (130, 2100, True), (1920, 1920, True)]


def _numpy_visits(q_len, kv_len, causal, bm=BM, bn=BN):
    """Per q tile, the kv tiles holding a pair it sees, counted from the
    mask itself; a q tile that sees nothing visits one."""
    vis = visible_mask(q_len, kv_len, "cpu", causal=causal)
    vis = np.ones((q_len, kv_len), bool) if vis is None \
        else vis.numpy().reshape(q_len, kv_len)
    n_q, n_kv = -(-q_len // bm), -(-kv_len // bn)
    pad = np.zeros((n_q * bm, n_kv * bn), bool)
    pad[:q_len, :kv_len] = vis
    tiles = pad.reshape(n_q, bm, n_kv, bn).any(axis=(1, 3))
    counts = tiles.sum(axis=1)
    # causal: the pairs a tile sees form a prefix of the kv tiles
    for t in range(n_q):
        assert not tiles[t, counts[t]:].any()
    return np.maximum(counts, 1)


@pytest.mark.parametrize("q_len,kv_len,causal", SHAPES)
def test_kv_tile_counts_match_numpy_visits(q_len, kv_len, causal):
    np.testing.assert_array_equal(
        kv_tile_counts(q_len, kv_len, causal, BM, BN),
        _numpy_visits(q_len, kv_len, causal))


@pytest.mark.parametrize("q_len,kv_len,causal", SHAPES)
def test_schedule_deals_every_tile_once_and_evens_out(q_len, kv_len, causal):
    table = v1_schedule(q_len, kv_len, causal)
    n_q = -(-q_len // BM)
    assert table.dtype == np.int32
    assert table.shape == (-(-n_q // FLASH_V1_BF16_Q_TILES),
                           FLASH_V1_BF16_Q_TILES)
    dealt = table[table >= 0]
    assert sorted(dealt.tolist()) == list(range(n_q))
    # the empty places are only those the tile count leaves over (with an
    # odd count the block of the longest tile takes it alone)
    assert (table < 0).sum() == table.size - n_q
    assert (table >= 0).any(axis=1).all()
    work = _numpy_visits(q_len, kv_len, causal)
    steps = np.where(table >= 0, work[np.maximum(table, 0)], 0).sum(axis=1)
    # the blocks' kv steps (a (kv tile, q tile) pair each) add up to the
    # visible pairs, and no block does more than another by more than one
    # tile's walk
    assert steps.sum() == work.sum()
    assert steps.max() - steps.min() <= work.max()
    if causal and q_len == kv_len and n_q % (2 * FLASH_V1_BF16_Q_TILES) == 0:
        assert steps.max() == steps.min()   # n - 1 - i beside i


def test_schedule_pairs_the_benchmark_shape():
    """At (2048, 2048) causal: 8 blocks a head, block i takes q tiles
    15 - i (16 - i kv steps) and i (i + 1): 17 steps each."""
    table = v1_schedule(2048, 2048, True)
    np.testing.assert_array_equal(table[:, 0], np.arange(15, 7, -1))
    np.testing.assert_array_equal(table[:, 1], np.arange(8))


F32_BM, F32_BN = FLASH_V1_F32.block_m, FLASH_V1_F32.block_n


@pytest.mark.parametrize("q_len,kv_len,causal", SHAPES)
def test_f32_schedule_deals_every_tile_once_and_evens_out(q_len, kv_len,
                                                          causal):
    """The f32 kernel's schedule: v1_schedule at its 64-row tiles and two q
    tiles a block (v1_config), against the visits counted from the mask."""
    cfg, per_block = v1_config(torch.float32)
    assert (cfg, per_block) == (FLASH_V1_F32, FLASH_V1_F32_Q_TILES) \
        and per_block >= 2
    table = v1_schedule(q_len, kv_len, causal, cfg.block_m, cfg.block_n,
                        per_block)
    n_q = -(-q_len // F32_BM)
    assert table.shape == (-(-n_q // per_block), per_block)
    assert sorted(table[table >= 0].tolist()) == list(range(n_q))
    work = _numpy_visits(q_len, kv_len, causal, F32_BM, F32_BN)
    np.testing.assert_array_equal(
        kv_tile_counts(q_len, kv_len, causal, F32_BM, F32_BN), work)
    steps = np.where(table >= 0, work[np.maximum(table, 0)], 0).sum(axis=1)
    assert steps.sum() == work.sum()
    assert steps.max() - steps.min() <= work.max()
    if causal and q_len == kv_len and n_q % (2 * per_block) == 0:
        assert steps.max() == steps.min()


def test_f32_schedule_fills_the_card():
    """At the benchmark's (2, 8, 1024) causal: 16 q tiles a head, 8 blocks
    a head of tiles 15 - i and i (17 kv steps each), 128 blocks in all on
    the H100's 132 SMs, each walking two q tiles."""
    cfg, per_block = v1_config(torch.float32)
    table = v1_schedule(1024, 1024, True, cfg.block_m, cfg.block_n,
                        per_block)
    assert table.shape[0] * 2 * 8 >= 128
    np.testing.assert_array_equal(table[:, 0], np.arange(15, 7, -1))
    np.testing.assert_array_equal(table[:, 1], np.arange(8))
    assert (table >= 0).all()


@pytest.mark.parametrize("d", [64, 128])
def test_state_scratch_sizes(d):
    # bf16: per (head, 128-row q tile) two warpgroups of 128 threads, each
    # d / 2 accumulator floats and (m, m', l, l')
    assert v1_state_floats(torch.bfloat16, 3, 300, d) \
        == 3 * 3 * 2 * 128 * (d // 2 + 4)
    # f32: per (head, 64-row q tile) the 256 PV threads' accumulator tiles
    # (d / 16 float4s each) and the (m, l) of the 64 rows
    assert v1_state_floats(torch.float32, 3, 300, d) == 3 * 320 * (d + 2)
    assert v1_state_floats(torch.float32, 1, 64, d) \
        == 256 * (d // 16) * 4 + 64 * 2


@pytest.mark.parametrize("d", [64, 128])
def test_smem_budgets_fit_a_block(d):
    bf16 = v1_smem_bytes(FLASH_V1_BF16, d)
    # the q ring, the K/V ring, five mbarriers a stage, the 1024-byte
    # alignment
    assert bf16 == FLASH_V1_BF16_STAGES * (BM * d * 2 + 2 * BN * d * 2
                                           + 5 * 8) + 1024
    for size in (bf16, v1_smem_bytes(FLASH_V1_F32, d),
                 bwd_f32_smem_bytes(d)):
        assert 0 < size <= SMEM_PER_BLOCK
    # a third K/V stage would not fit beside two q stages at head_dim 128
    if d == 128:
        assert bf16 + 2 * BN * d * 2 > SMEM_PER_BLOCK
    # f32: the K and V rings, a q and a p'^T tile per S group, their rows'
    # (max, sum), twelve mbarriers; one block of 17 warps an SM at 128
    f32 = v1_smem_bytes(FLASH_V1_F32, d)
    assert f32 == (4 * 64 * d + 2 * 64 * d + 2 * 64 * 64 + 4 * 64) * 4 + 96
    assert FLASH_V1_F32.threads == 17 * 32
    if d == 128:
        assert f32 == 230496
    with pytest.raises(ValueError):
        v1_smem_bytes(FLASH_V1_BF16.__class__(64, 64, 128), d)
