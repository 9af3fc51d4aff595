"""The forward kernels' tile tables and shared-memory budgets, on the CPU.

The bf16 forward (wgmma, 128-row tiles; over bf16 K/V and over int8/e4m3
payloads alike) and the f32 instances (128-row q and 64-row kv tiles, over
f32 K/V and over payloads) prune a packed row's work with tables built for
their own tiles from one `SegmentTiles` (ops/flash.py): the bf16 kernel's
`tile_table`, the f32 kernel's `fwd_f32_tiles`, cut into its work list.
Held here:

  * every (row, column) pair that `visible_mask` lets through lies in its
    q tile's kv range [lo, hi) of `tile_table` (`fwd_f32_tiles` for the f32
    instances, which agrees with it), for random packed starts, causal and
    not, at every forward config, so no kernel skips a visible tile;
  * the block order is a permutation of the q tiles, longest range first;
  * one `SegmentTiles` feeds `flash_attention` and
    `flash_attention_quantized` (their plain versions here), builds one
    table per config on first use, and both agree with the JAX package's
    entries with `segment_starts` (its Pallas kernels in interpret mode)
    within the dtype gates;
  * `fwd_smem_bytes` (which the libraries' own sizes are held to when
    they load, on the card) fits a block's 227 KB at head_dim 64 and 128
    for every forward instance; the quantized bf16-q instances take B1's
    layout;
  * the bf16 kernel's pair conversion of payload bytes, mirrored by
    `convert_pairs`, gives `payload_to_compute`'s bits for all 65,536 byte
    pairs of int8 and of e4m3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops import quant as JQ
from tiny_flash_attention_tpu.ops.configs import FlashConfig
from tiny_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from tiny_flash_attention_tpu.ops.flash_quant import (
    flash_attention_quantized as jax_flash_quantized)
from tiny_flash_attention_tpu_torch.models.transformer import (
    quantized_from_jax)
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_FWD_BF16, FLASH_FWD_BF16_WIDE, FLASH_FWD_F32,
    SMEM_PER_BLOCK, TileConfig, bwd_smem_bytes, fwd_smem_bytes)
from tiny_flash_attention_tpu_torch.ops.flash import (
    check_smem_layouts, flash_attention, fwd_config, fwd_f32_tiles,
    segment_tiles, tile_table, visible_mask)
from tiny_flash_attention_tpu_torch.ops.flash_quant import (
    convert_pairs, flash_attention_quantized, payload_to_compute)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

# the tiles of each forward instance's table (bf16 q over quantized K/V
# runs the bf16 kernel, on its tiles)
CONFIGS = {"bf16": FLASH_FWD_BF16, "f32": FLASH_FWD_F32,
           "quant_bf16": fwd_config(torch.bfloat16, quantized=True),
           "bf16_wide": fwd_config(torch.bfloat16, head_dim=256)}
# every forward instance: its tiles, and whether its K/V are quantized
INSTANCES = {"bf16": (FLASH_FWD_BF16, False), "f32": (FLASH_FWD_F32, False),
             "quant_bf16": (FLASH_FWD_BF16, True),
             "quant_f32": (FLASH_FWD_F32, True)}
INTERP = FlashConfig(block_q=128, block_kv=128, interpret=True)


def _packed(seed: int, q_len: int):
    """Random segment starts of one packed row (0 first) and its ids."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9)) if q_len > 1 else 1
    starts = np.unique(np.concatenate(
        [[0], rng.integers(1, max(q_len, 2), n - 1)])).tolist()
    ids = np.searchsorted(np.asarray(starts), np.arange(q_len),
                          side="right").astype(np.int32)[None]
    return starts, ids


@pytest.mark.parametrize("cfg", list(CONFIGS), ids=list(CONFIGS))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("seed,q_len", [(0, 1), (1, 127), (2, 129),
                                        (3, 300), (4, 640), (5, 1000),
                                        (6, 2049)])
def test_visible_pairs_lie_in_their_tile_range(cfg, causal, seed, q_len):
    bm, bn = CONFIGS[cfg].block_m, CONFIGS[cfg].block_n
    starts, ids = _packed(seed, q_len)
    lo, hi, order = tile_table(starts, q_len, causal=causal, block_m=bm,
                               block_n=bn)
    if CONFIGS[cfg] is FLASH_FWD_F32:
        f32 = fwd_f32_tiles(q_len, q_len, causal=causal, starts=starts)
        assert all(x.tolist() == y.tolist()
                   for x, y in zip(f32, (lo, hi, order)))
    t = torch.from_numpy(ids)
    vis = visible_mask(q_len, q_len, "cpu", causal=causal,
                       segment_ids=(t, t))[0, 0].numpy()
    rows, cols = np.nonzero(vis)
    kv_tile = cols // bn
    assert (lo[rows // bm] <= kv_tile).all()
    assert (kv_tile < hi[rows // bm]).all()
    assert sorted(order.tolist()) == list(range(-(-q_len // bm)))
    work = (hi - lo)[order]
    assert (np.diff(work) <= 0).all()   # longest range first


def test_one_segment_tiles_serve_both_entries_as_jax():
    """One SegmentTiles for flash_attention and flash_attention_quantized
    on the same packed row; each entry's output against JAX's with the
    static starts, and one table per config once built."""
    q_len, d = 640, 64
    starts, ids = _packed(4, q_len)
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 4, q_len, d)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    t_ids = torch.from_numpy(ids)
    j_ids = jnp.asarray(ids)
    tiles = segment_tiles(starts, q_len, causal=True, device="cpu")
    atol = tolerance_for(torch.float32)

    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True,
                          segment_ids=(t_ids, t_ids), segment_starts=tiles)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, segment_ids=(j_ids, j_ids),
                     segment_starts=tuple(starts), config=INTERP)
    assert float(np.max(np.abs(out.numpy() - np.asarray(want)))) <= atol

    jk, jv = JQ.quantize_kv(jnp.asarray(k), jnp.asarray(v), "int8")
    tk, tv = (quantized_from_jax(jax.tree.map(np.asarray, x), device="cpu")
              for x in (jk, jv))
    got = flash_attention_quantized(torch.from_numpy(q), tk, tv, causal=True,
                                    segment_ids=(t_ids, t_ids),
                                    segment_starts=tiles)
    want = jax_flash_quantized(jnp.asarray(q), jk, jv, causal=True,
                               segment_ids=(j_ids, j_ids),
                               segment_starts=tuple(starts), config=INTERP)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= atol

    # the device tables: one per forward config, built once each; the
    # quantized bf16-q entry shares the bf16 kernel's; the f32 instances
    # take the same starts into their own ranges (their work list)
    bf16 = tiles.table(fwd_config(torch.bfloat16))
    quant = tiles.table(fwd_config(torch.bfloat16, quantized=True))
    f32 = tuple(torch.as_tensor(x, dtype=torch.int32) for x in
                fwd_f32_tiles(q_len, q_len, causal=True,
                              starts=tiles.starts)[::2])
    assert tiles.table(fwd_config(torch.bfloat16)) is bf16
    assert quant is bf16
    for (lo, order), cfg in ((bf16, FLASH_FWD_BF16), (f32, FLASH_FWD_F32)):
        want_lo, _, want_order = tile_table(
            starts, q_len, causal=True, block_m=cfg.block_m,
            block_n=cfg.block_n)
        assert lo.dtype == torch.int32 and order.dtype == torch.int32
        assert lo.tolist() == want_lo.tolist()
        assert order.tolist() == want_order.tolist()
    assert len(bf16[0]) == -(-q_len // FLASH_FWD_BF16.block_m)
    assert len(f32[0]) == -(-q_len // FLASH_FWD_F32.block_m)


@pytest.mark.parametrize("cfg", list(INSTANCES), ids=list(INSTANCES))
@pytest.mark.parametrize("head_dim", [64, 128])
def test_forward_smem_fits_a_block(cfg, head_dim):
    tiles, quantized = INSTANCES[cfg]
    nbytes = fwd_smem_bytes(tiles, head_dim, quantized)
    assert 0 < nbytes <= SMEM_PER_BLOCK == 227 * 1024


def test_fwd_config_by_dtype_and_payload():
    assert fwd_config(torch.bfloat16) is FLASH_FWD_BF16
    assert fwd_config(torch.float32) is FLASH_FWD_F32
    # bf16 q over payloads runs the bf16 kernel, its tiles and its layout
    assert fwd_config(torch.bfloat16, quantized=True) is FLASH_FWD_BF16
    assert fwd_config(torch.float32, quantized=True) is FLASH_FWD_F32
    # ... and its layout, with a payload-copy mbarrier a stage: q, three
    # stages of K, V and ids, 13 mbarriers, the alignment slack
    for d in (64, 128):
        assert (fwd_smem_bytes(FLASH_FWD_BF16, d, quantized=True)
                == fwd_smem_bytes(FLASH_FWD_BF16, d) + 3 * 8)
    assert fwd_smem_bytes(FLASH_FWD_BF16, 128) == 232016
    assert fwd_smem_bytes(FLASH_FWD_BF16, 128, True) == 232040
    assert fwd_smem_bytes(FLASH_FWD_BF16, 64, True) == (
        128 * 64 * 2 + 3 * (2 * 128 * 64 * 2 + 128 * 4) + 13 * 8 + 1024)
    # the f32 body: q, two stages of K and V, P^T, each stage's kv ids;
    # its quantized instances add each stage's k and v scales
    assert fwd_smem_bytes(FLASH_FWD_F32, 128) == (
        (128 * 128 + 4 * 64 * 128 + 64 * 128) * 4 + 2 * 64 * 4) == 229888
    assert (fwd_smem_bytes(FLASH_FWD_F32, 128, True)
            == fwd_smem_bytes(FLASH_FWD_F32, 128) + 2 * 2 * 64 * 4)
    with pytest.raises(ValueError):
        fwd_smem_bytes(TileConfig(64, 64, 128), 128)
    with pytest.raises(ValueError):
        fwd_smem_bytes(TileConfig(64, 64, 128), 128, quantized=True)


def test_wide_instances_fit_a_block():
    """The head_dim-256 instances' budgets: B1 over 64-row kv tiles in two
    stages with K's and V's empty barriers apart (q 64 KiB, two stages of
    K, V and ids, 1 + 4 x 2 mbarriers, the alignment slack), where three
    stages or 128-row tiles would not fit; the backward's wide main kernel
    (K, V, one stage of qs, q and dout, the rows' kilobyte, P^T and two
    dS^T tiles, the mbarriers' 64 bytes, the slack)."""
    wide = fwd_smem_bytes(FLASH_FWD_BF16_WIDE, 256)
    assert wide == (128 * 256 * 2 + 2 * (2 * 64 * 256 * 2 + 64 * 4)
                    + 9 * 8 + 1024) == 198216 <= SMEM_PER_BLOCK
    # two stages of 128-row tiles, or three of 64-row ones, would not fit
    assert 128 * 256 * 2 + 2 * 2 * 128 * 256 * 2 > SMEM_PER_BLOCK
    assert 128 * 256 * 2 + 3 * 2 * 64 * 256 * 2 > SMEM_PER_BLOCK
    assert bwd_smem_bytes(256) == (2 * 64 * 256 * 2 + 3 * 64 * 256 * 2
                                   + 1024 + 3 * 64 * 64 * 2 + 64 + 1024)
    assert bwd_smem_bytes(256) == 190528 <= SMEM_PER_BLOCK
    # the 128-row layout at 256 would not fit
    assert (2 * 128 * 256 * 2 + 2 * 3 * 64 * 256 * 2) > SMEM_PER_BLOCK
    for d in (64, 128):
        assert 0 < bwd_smem_bytes(d) <= SMEM_PER_BLOCK
    assert bwd_smem_bytes(128) == 216128


class _BwdLibrary:
    """Stands in for a built backward library: its bf16 main kernels'
    shared-memory sizes by head_dim."""

    def __init__(self, sizes):
        self.tfa_flash_bwd_bf16_smem = lambda head_dim: sizes[head_dim]


def test_bwd_smem_is_held_to_the_library():
    """check_bf16_smem passes where the library's sizes are
    bwd_smem_bytes' at 64, 128, 256 and 512, and raises where one
    differs."""
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import check_bf16_smem

    sizes = {d: bwd_smem_bytes(d) for d in (64, 128, 256, 512)}
    check_bf16_smem(_BwdLibrary(sizes))
    for d in (256, 512):
        wrong = dict(sizes)
        wrong[d] += 64
        with pytest.raises(RuntimeError, match="bwd_smem_bytes"):
            check_bf16_smem(_BwdLibrary(wrong))


class _Library:
    """Stands in for a built forward library: its exported shared-memory
    sizes by (dtype code, head_dim), for both sources."""

    def __init__(self, sizes):
        def smem(dtype, head_dim):
            return sizes[(dtype, head_dim)]
        self.tfa_flash_fwd_smem = smem
        self.tfa_flash_fwd_quant_smem = smem


@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "quant"])
def test_smem_layouts_are_held_to_the_library(quantized):
    """check_smem_layouts passes where the library's sizes are
    fwd_smem_bytes' and raises where one instance's differs."""
    # every tile width, the wide instances' (both sources) included, and
    # those of width 512 over K/V of q's dtype (bf16 and f32)
    sizes = {(code, d): fwd_smem_bytes(fwd_config(dtype, quantized, d), d,
                                       quantized)
             for dtype, code in ((torch.bfloat16, 0), (torch.float32, 1))
             for d in (64, 128, 256, *(() if quantized else (512,)))}
    check_smem_layouts(_Library(sizes), quantized)
    sizes[(0, 64)] += 16
    with pytest.raises(RuntimeError, match="fwd_smem_bytes"):
        check_smem_layouts(_Library(sizes), quantized)


@pytest.mark.parametrize("fmt,dtype", [("int8", torch.int8),
                                       ("fp8", torch.float8_e4m3fn)],
                         ids=["int8", "e4m3"])
def test_pair_conversion_matches_payload_to_compute(fmt, dtype):
    """The bf16 kernel converts two payload bytes an instruction (int8: a
    byte permute, lop3 and a bf16x2 fma against a magic number; e4m3:
    JAX's integer mapping with shifts, a sign-replicating byte permute and
    lop3): its mirror `convert_pairs` gives payload_to_compute's bf16 bits
    for every one of the 65,536 byte pairs, zeros' signs, the subnormal
    e4m3 codes (landing high) and the NaN codes (+/-480) included."""
    pairs = torch.arange(1 << 16)
    got = convert_pairs(pairs, fmt)
    payload = torch.stack([pairs & 0xFF, pairs >> 8], -1).to(
        torch.uint8).view(dtype)
    want = payload_to_compute(payload, torch.bfloat16).view(
        torch.int16).to(torch.int64) & 0xFFFF
    assert got.shape == want.shape == (1 << 16, 2)
    assert torch.equal(got, want)
