"""Head_dim 256 in the quantized forward and in FA1 against the JAX package,
on the CPU.

The JAX package pads any head_dim to whole 128-lane tiles in
`flash_attention_quantized` (its `_flash_fwd_impl`) and in FA1, so both
take 192 and 256. The port's quantized forward (int8/e4m3 K/V with
per-token scales; bf16, f32 and fp16 q) and FA1 (bf16, f32) compile
instances of 256 columns and pad every head_dim in (128, 256] to 256 on
the card (ops/dims.py: q with zero columns, the payloads with code 0
through a byte view, an exact zero), with the softmax scale from the true
head_dim. Here the same numpy inputs, made from a seed, go through the
JAX function (its Pallas kernels in interpret mode, on the same payload
bytes, which JAX's quantizer makes and `quantized_from_jax` hands over)
and through the port: its public entry (the plain version at the true
head_dim, on the CPU) and the padded route the card takes (pad to 256,
the plain version, unpad). Gates: the dtype gates of utils/testing.py
(f32 2e-5, bf16 2e-2, fp16 1e-2) on out, the LSE at rtol 1e-5 in f32 (at
the dtype gate otherwise, as tests/test_torch_flash.py holds it). The
host-side layouts of the new instances are held here too: their shared
memory, the wide FA1 schedule and its state scratch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops import quant as JQ
from tiny_flash_attention_tpu.ops.configs import FlashConfig
from tiny_flash_attention_tpu.ops.flash_quant import (
    flash_attention_quantized as jax_flash_quantized)
from tiny_flash_attention_tpu.ops.flash_v1 import (
    flash_attention_v1 as jax_v1)
from tiny_flash_attention_tpu_torch.models.transformer import (
    quantized_from_jax)
from tiny_flash_attention_tpu_torch.ops import dims
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_FWD_BF16_WIDE, FLASH_FWD_F32_WIDE, FLASH_V1_BF16_Q_TILES,
    FLASH_V1_BF16_WIDE, FLASH_V1_F32_Q_TILES, FLASH_V1_F32_WIDE,
    SMEM_PER_BLOCK, fwd_smem_bytes, v1_smem_bytes)
from tiny_flash_attention_tpu_torch.ops.flash import (
    fwd_config, visible_mask)
from tiny_flash_attention_tpu_torch.ops.flash_quant import (
    flash_attention_quantized, flash_attention_quantized_plain)
from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
    flash_attention_v1, flash_attention_v1_plain, kv_tile_counts, v1_config,
    v1_schedule, v1_state_floats)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

INTERP = FlashConfig(block_q=128, block_kv=128, interpret=True)
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _lse_close(got, want, dtype, name):
    np.testing.assert_allclose(
        _np(got), _np(want), rtol=1e-5,
        atol=0 if dtype == torch.float32 else tolerance_for(dtype),
        err_msg=name)


def _out_close(got, want, dtype, name):
    err = float(np.max(np.abs(_np(got) - _np(want))))
    assert err <= tolerance_for(dtype), \
        f"{name}: max abs err {err:.3e} > {tolerance_for(dtype):.0e}"


# --- the quantized forward ---------------------------------------------------


def _quant_inputs(seed, q_shape, kv_shape, fmt, dtype):
    """q in `dtype` for both packages; K and V quantized by JAX, and the
    same payload bytes and scales as the port's QuantizedTensors."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal(q_shape).astype(np.float32))
    q = q.to(dtype)
    jq = jnp.asarray(q.float().numpy(), _JNP[dtype])
    k = jnp.asarray(rng.standard_normal(kv_shape).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(kv_shape).astype(np.float32))
    jk, jv = JQ.quantize_kv(k, v, fmt)
    tk, tv = (quantized_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in (jk, jv))
    return (q, tk, tv), (jq, jk, jv)


def _ids(n, bounds):
    ids = np.zeros((1, n), np.int32)
    for i, x in enumerate(bounds):
        ids[:, x:] = i + 1
    return ids


def _padded_quantized(q, k, v, *, sm_scale, **kw):
    """The card's route at a head_dim below 256: q and both payloads
    padded to 256 (the payloads with code 0 through pad_head_dim's byte
    view), the plain version there with the true head_dim's scale, out
    sliced back."""
    d = q.shape[-1]
    qp, kp, vp = (dims.pad_head_dim(t, 256)
                  for t in (q, k.values, v.values))
    out, lse = flash_attention_quantized_plain(
        qp, kp, vp, k.scales, v.scales, sm_scale=sm_scale,
        return_lse=True, **kw)
    return dims.unpad_head_dim(out, d), lse


# (head_dim, q dtype, payload format, group, mask): every head_dim with
# every q dtype and both formats, groups 1 and 8, and each mask (causal,
# non-causal, the window, segment ids) at each head_dim
QUANT_CASES = [
    (192, torch.bfloat16, "int8", 1, "causal"),
    (192, torch.bfloat16, "fp8", 8, "ids"),
    (192, torch.float32, "int8", 8, "window"),
    (192, torch.float32, "fp8", 1, "noncausal"),
    (192, torch.float16, "int8", 8, "noncausal"),
    (192, torch.float16, "fp8", 1, "causal"),
    (256, torch.bfloat16, "int8", 8, "window"),
    (256, torch.bfloat16, "fp8", 1, "noncausal"),
    (256, torch.float32, "int8", 1, "ids"),
    (256, torch.float32, "fp8", 8, "causal"),
    (256, torch.float16, "int8", 1, "window"),
    (256, torch.float16, "fp8", 8, "ids"),
    (256, torch.bfloat16, "int8", 8, "causal"),
    (256, torch.float32, "int8", 8, "noncausal"),
]


def _mask_kwargs(mask, n):
    kw = {"causal": mask != "noncausal"}
    if mask == "window":
        kw["window"] = 64
    ids = _ids(n, (70, 150)) if mask == "ids" else None
    return kw, ids


@pytest.mark.parametrize(
    "d,dtype,fmt,group,mask", QUANT_CASES,
    ids=[f"d{c[0]}-{str(c[1]).split('.')[-1]}-{c[2]}-g{c[3]}-{c[4]}"
         for c in QUANT_CASES])
def test_quantized_matches_jax(d, dtype, fmt, group, mask):
    """flash_attention_quantized at head_dim 192 and 256: out and the LSE
    against JAX's kernels in interpret mode on the same payload bytes,
    through the entry (true width) and through the padded route."""
    n = 200
    (q, k, v), (jq, jk, jv) = _quant_inputs(d + group, (1, group, n, d),
                                            (1, 1, n, d), fmt, dtype)
    kw, ids = _mask_kwargs(mask, n)
    jsegs = tsegs = None
    if ids is not None:
        jsegs = (jnp.asarray(ids), jnp.asarray(ids))
        tsegs = (torch.from_numpy(ids), torch.from_numpy(ids))
    jout, jlse = jax_flash_quantized(jq, jk, jv, config=INTERP,
                                     segment_ids=jsegs, return_lse=True,
                                     **kw)
    out, lse = flash_attention_quantized(q, k, v, segment_ids=tsegs,
                                         return_lse=True, **kw)
    assert out.dtype == dtype and tuple(out.shape) == (1, group, n, d)
    assert lse.dtype == torch.float32
    _out_close(out, jout, dtype, "out")
    _lse_close(lse, jlse, dtype, "lse")
    assert torch.equal(flash_attention_quantized(q, k, v, segment_ids=tsegs,
                                                 **kw), out)
    # the card's route: padded to 256, the true head_dim's scale; fp16 q
    # computes in f32, as the entry does
    qc = q.float() if dtype == torch.float16 else q
    pout, plse = _padded_quantized(qc, k, v, sm_scale=d ** -0.5,
                                   segment_ids=tsegs, **kw)
    _out_close(pout.to(dtype), jout, dtype, "padded out")
    _lse_close(plse, jlse, dtype, "padded lse")


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_decode_offset_and_empty_rows_match_jax(fmt):
    """At 256, a bf16 decode chunk over a longer cache (the decode
    offset), and q_len > kv_len in f32: rows before every kv position are
    0 with the sentinel, as in JAX."""
    (q, k, v), (jq, jk, jv) = _quant_inputs(
        7, (1, 8, 16, 256), (1, 1, 300, 256), fmt, torch.bfloat16)
    jout = jax_flash_quantized(jq, jk, jv, config=INTERP, causal=True)
    _out_close(flash_attention_quantized(q, k, v, causal=True), jout,
               torch.bfloat16, "decode offset")
    (q, k, v), (jq, jk, jv) = _quant_inputs(
        8, (1, 2, 300, 256), (1, 1, 180, 256), fmt, torch.float32)
    jout, jlse = jax_flash_quantized(jq, jk, jv, config=INTERP,
                                     causal=True, return_lse=True)
    out, lse = flash_attention_quantized(q, k, v, causal=True,
                                         return_lse=True)
    _out_close(out, jout, torch.float32, "q_len > kv_len")
    _lse_close(lse, jlse, torch.float32, "q_len > kv_len lse")
    assert bool((out[:, :, :120] == 0).all())


def test_quantized_rule_pads_payloads_with_code_zero():
    """The quantized forward pads (128, 256] to 256 and raises from 257;
    a payload's pad columns are code 0 (an exact zero in int8 and e4m3),
    counted as one copy each; 256 itself is not copied."""
    what = "the CUDA forward kernel"
    for d in (129, 192, 200, 256):
        for dtype in (torch.bfloat16, torch.float32):
            assert dims.flash_head_dim(d, dtype, what, quantized=True) == 256
    with pytest.raises(NotImplementedError, match="int8/e4m3 K/V takes "
                       "head_dim up to 256"):
        dims.flash_head_dim(257, torch.bfloat16, what, quantized=True)
    for dtype in (torch.int8, torch.float8_e4m3fn):
        x = torch.full((1, 1, 3, 192), 1.0).to(dtype)
        before = dims.pad_head_dim.copies
        y = dims.pad_head_dim(x, 256)
        assert dims.pad_head_dim.copies == before + 1
        assert y.dtype == dtype and y.shape[-1] == 256
        assert bool((y[..., 192:].view(torch.uint8) == 0).all())
        assert bool((y[..., 192:].float() == 0).all())
        assert torch.equal(y[..., :192].view(torch.uint8),
                           x.view(torch.uint8))
        assert dims.pad_head_dim(y, 256) is y
        assert dims.pad_head_dim.copies == before + 1


# --- FA1 -----------------------------------------------------------------------


def _v1_inputs(seed, q_len, kv_len, d, dtype, h=2):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, h, q_len, d), (1, h, kv_len, d),
                      (1, h, kv_len, d))]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a, _JNP[dtype]) for a in arrs])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("d", [192, 256])
def test_v1_matches_jax(d, dtype, causal):
    """flash_attention_v1 at head_dim 192 and 256, against JAX's FA1 kernel
    in interpret mode: through the entry (true width) and through the
    padded route (q, k, v padded to 256, the true head_dim's scale)."""
    q_len, kv_len = (300, 260) if causal else (200, 333)
    (q, k, v), (jq, jk, jv) = _v1_inputs(d, q_len, kv_len, d, dtype)
    out, lse = flash_attention_v1(q, k, v, causal=causal, block_q=128,
                                  block_kv=128, return_lse=True)
    jout, jlse = jax_v1(jq, jk, jv, causal=causal, block_q=128,
                        block_kv=128, return_lse=True, interpret=True)
    assert out.dtype == dtype and out.shape == q.shape
    _out_close(out, jout, dtype, "out")
    # rows that see no column (causal, q_len > kv_len): JAX leaves the
    # sentinel or -inf by block; compare the LSE where a row sees one
    seen = max(0, q_len - kv_len) if causal else 0
    _lse_close(lse[:, :, seen:], np.asarray(jlse)[:, :, seen:], dtype,
               "lse")
    pout, plse = flash_attention_v1_plain(
        *(dims.pad_head_dim(t, 256) for t in (q, k, v)), causal=causal,
        sm_scale=d ** -0.5)
    _out_close(dims.unpad_head_dim(pout, d), jout, dtype, "padded out")
    _lse_close(plse[:, :, seen:], np.asarray(jlse)[:, :, seen:], dtype,
               "padded lse")


def test_v1_rule_pads_to_256():
    """FA1 pads (128, 256] to 256 and raises from 257, naming itself."""
    for d in (129, 192, 256):
        assert dims.kernel_head_dim(d, "the CUDA FA1 kernel", wide=True) \
            == 256
    with pytest.raises(NotImplementedError,
                       match="the CUDA FA1 kernel takes head_dim up to 256"):
        dims.kernel_head_dim(264, "the CUDA FA1 kernel", wide=True)


# --- host layouts of the new instances ----------------------------------------


def test_quantized_wide_instances_shared_memory():
    """The quantized forward at 256 takes the wide instances' tiles (bf16
    q: 64-row kv tiles in two stages, K's and V's payload copies on
    barriers of their own; f32 q: 64-row q and 32-row kv tiles), laid out
    under a block's 227 KB."""
    for dtype, cfg in ((torch.bfloat16, FLASH_FWD_BF16_WIDE),
                       (torch.float32, FLASH_FWD_F32_WIDE)):
        assert fwd_config(dtype, quantized=True, head_dim=256) is cfg
        assert fwd_config(dtype, quantized=True, head_dim=128) \
            is fwd_config(dtype, head_dim=128)
    bf16 = fwd_smem_bytes(FLASH_FWD_BF16_WIDE, 256, quantized=True)
    f32 = fwd_smem_bytes(FLASH_FWD_F32_WIDE, 256, quantized=True)
    # q 64 KiB, two stages of 64-row K and V (32 KiB each) and their ids,
    # 13 mbarriers and the 1024 bytes that align the base
    assert bf16 == 65536 + 2 * (2 * 32768 + 256) + 13 * 8 + 1024 == 198248
    # q 64 KiB, two stages of 32-row K and V, P^T, and each stage's ids and
    # k and v scales, all 4-byte
    assert f32 == (64 * 256 + 4 * 32 * 256 + 32 * 64 + 2 * 3 * 32) * 4 \
        == 205568
    assert max(bf16, f32) <= SMEM_PER_BLOCK


def test_v1_wide_instances_shared_memory():
    """FA1 at 256: bf16 on 128-row q and 64-row kv tiles (one q stage, two
    K/V stages), f32 on 32 x 32 tiles; both under a block's 227 KB, where
    the 128 instances' tiles would need 394,320 and 427,104 bytes."""
    assert v1_config(torch.bfloat16, 256) == (FLASH_V1_BF16_WIDE,
                                              FLASH_V1_BF16_Q_TILES)
    assert v1_config(torch.float32, 256) == (FLASH_V1_F32_WIDE,
                                             FLASH_V1_F32_Q_TILES)
    bf16 = v1_smem_bytes(FLASH_V1_BF16_WIDE, 256)
    f32 = v1_smem_bytes(FLASH_V1_F32_WIDE, 256)
    assert bf16 == 65536 + 2 * 8 + 2 * (2 * 32768 + 3 * 8) + 1024 == 197696
    assert f32 == (4 * 32 * 256 + 2 * 32 * 256 + 2 * 32 * 32 + 4 * 32) * 4 \
        + 12 * 8 == 205408
    assert max(bf16, f32) <= SMEM_PER_BLOCK
    assert v1_smem_bytes(v1_config(torch.bfloat16)[0], 256) == 394320
    assert v1_smem_bytes(v1_config(torch.float32)[0], 256) == 427104


def _visible_tile_pairs(q_len, kv_len, causal, bm, bn):
    """(q tile, kv tile) pairs that hold a visible (row, column) pair,
    from the mask itself."""
    vis = visible_mask(q_len, kv_len, "cpu", causal=causal)
    vis = np.ones((q_len, kv_len), bool) if vis is None \
        else vis.numpy().reshape(q_len, kv_len)
    n_q, n_kv = -(-q_len // bm), -(-kv_len // bn)
    pad = np.zeros((n_q * bm, n_kv * bn), bool)
    pad[:q_len, :kv_len] = vis
    return pad.reshape(n_q, bm, n_kv, bn).any(axis=(1, 3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("q_len,kv_len,causal", [
    (2048, 2048, True), (2048, 2048, False), (1024, 1024, True),
    (300, 260, True), (100, 333, True), (257, 255, False), (1, 2100, True),
])
def test_v1_wide_schedule_covers_every_visible_pair_once(q_len, kv_len,
                                                         causal, dtype):
    """v1_schedule at the wide instance's tiles: every q tile in one
    block's places once, and the kv tiles each walks ([0, hi),
    kv_tile_counts) hold every visible (q tile, kv tile) pair, each once,
    and no tile past the visible ones but the one a tile that sees
    nothing visits."""
    cfg, per_block = v1_config(dtype, 256)
    bm, bn = cfg.block_m, cfg.block_n
    table = v1_schedule(q_len, kv_len, causal, bm, bn, per_block)
    n_q = -(-q_len // bm)
    assert sorted(table[table >= 0].tolist()) == list(range(n_q))
    hi = kv_tile_counts(q_len, kv_len, causal, bm, bn)
    pairs = _visible_tile_pairs(q_len, kv_len, causal, bm, bn)
    walked = np.zeros_like(pairs, dtype=np.int64)
    for tile in table[table >= 0]:
        walked[tile, :hi[tile]] += 1
    assert (walked <= 1).all()
    assert (walked[pairs] == 1).all()
    extra = walked.astype(bool) & ~pairs
    assert all(not pairs[t].any() and extra[t].sum() == 1
               for t in np.nonzero(extra.any(axis=1))[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_v1_wide_state_scratch(dtype):
    """v1_state_floats at 256: bf16, per (head, 128-row q tile) two
    warpgroups of 128 threads, each 128 accumulator floats and (m, m', l,
    l'); f32, per (head, 32-row q tile) the PV threads' 8 x 4 accumulator
    tiles (32 x 256) and each PV warp's (m, l) of its 8 rows (a row group
    spans two warps)."""
    if dtype == torch.bfloat16:
        assert v1_state_floats(dtype, 3, 300, 256) \
            == 3 * 3 * 2 * 128 * (128 + 4) == 3 * 3 * 128 * 264
    else:
        assert v1_state_floats(dtype, 3, 300, 256) \
            == 3 * 10 * (256 * 8 * 4 + 8 * 8 * 2) == 3 * 320 * 260
    # the 128 instances keep theirs
    assert v1_state_floats(dtype, 1, 128, 128) \
        == (128 * 136 if dtype == torch.bfloat16 else 2 * 64 * 130)
