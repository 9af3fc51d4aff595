"""Head_dim 256 on the f32 path against the JAX package, on the CPU.

An f32 model at head_dim 256 serves over pages of its dtype (f32) and over
int8 pages, and trains: the JAX package pads its forward and backward to
256 lanes (its dispatch tables hold f32 tiles at 256) and its decodes and
append take any width. The port's f32 instances take head_dim 64, 128 and
256 (others in (128, 256] pad to 256); the decodes and the append compile
256 over every page format (ops/dims.py). Here the same numpy inputs, made
from a seed, go through the JAX function (its Pallas kernels in interpret
mode) and through the port: its public entry (the plain versions on the
CPU) and the layouts that the card's kernels compute, in plain PyTorch:
the f32 forward's kv runs merged in order (`f32_split_merge_plain`) and the
f32 backward's slots (`f32_slot_sums_plain`) at the wide instances' tiles,
and the decodes' padded rows and splits. Gates: f32 2e-5
(utils/testing.py), the LSE also at rtol 1e-5, the backward at JAX's 1e-5,
the append bit for bit; the train step's loss and gradients at 1e-5, as
tests/test_torch_train.py holds the head_dim-128 step. The host-side
layouts of the wide f32 instances are held here too: their shared memory,
work lists and merge workspace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_flash_attention_tpu.ops.flash_bwd as JFB
from tiny_flash_attention_tpu.models import inference as JI
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.models.engine import InferenceEngine as JEngine
from tiny_flash_attention_tpu.ops import paged_fused as jpf
from tiny_flash_attention_tpu.ops import quant as JQ
from tiny_flash_attention_tpu.ops.flash import _xla_attention
from tiny_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from tiny_flash_attention_tpu.ops.paged import (
    paged_decode_attention as jax_paged)
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine as TEngine)
from tiny_flash_attention_tpu_torch.ops import configs, dims
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.ops import quant as TQ
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_FWD_F32, FLASH_FWD_F32_WIDE, SMEM_PER_BLOCK, bwd_f32_config,
    bwd_f32_smem_bytes, bwd_f32_split, fwd_smem_bytes)
from tiny_flash_attention_tpu_torch.ops.flash import (
    f32_split_merge_plain, flash_attention, flash_attention_plain,
    fwd_config, fwd_f32_slots, fwd_f32_split, fwd_f32_work)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    bwd_tiles, f32_slot_sums_plain, f32_work, flash_attention_bwd)
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
from tiny_flash_attention_tpu_torch.parallel.train import (
    make_train_step, param_leaves)
from tiny_flash_attention_tpu.parallel.sharded import make_mesh
from tiny_flash_attention_tpu.parallel.train import (
    make_train_step as jax_make_train_step)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

F32 = tolerance_for(torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.0e}"


def _both(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def _ids(b, n, bounds):
    ids = np.zeros((b, n), np.int32)
    for i, x in enumerate(bounds):
        ids[:, x:] = i + 1
    return ids


# --- the rule and the layouts ------------------------------------------------


@pytest.mark.parametrize("d", [*range(129, 265), 384, 512, 520])
def test_f32_rule_above_128(d):
    """f32 takes every head_dim in (128, 256] on the wide instance, padded
    to 256 where d is not 256 (pad_head_dim counts the copy), and raises
    above 256 (ROADMAP queue B-dims-2a-f32); so do the quantized forward
    and FA1 (136 among them, 257 and 264 raising, queue
    B-dims-2a-quant-v1); the decodes take every head_dim up to 256 with
    f32 q (256 on its own instances, the others on the run-time width
    instances of width 256) and raise above, where the append and the
    decodes with bf16 q take it on the instances of width 512."""
    what = "the CUDA forward kernel"
    # the ROADMAP queue a refusal names: its own up to 512, B-dims-2a-512+
    # above
    above = "B-dims-2a-512\\+" if d > 512 else None
    if d > 256:
        with pytest.raises(NotImplementedError, match="up to 256.*"
                           + (above or "B-dims-2a-quant-v1")):
            dims.flash_head_dim(d, torch.float32, what, quantized=True)
        with pytest.raises(NotImplementedError, match="up to 256.*"
                           + (above or "B-dims-2a-quant-v1")):
            dims.kernel_head_dim(d, "the CUDA FA1 kernel", wide=True)
    else:
        assert dims.flash_head_dim(d, torch.float32, what,
                                   quantized=True) == 256
        assert dims.kernel_head_dim(d, "the CUDA FA1 kernel",
                                    wide=True) == 256
    if d > 256:
        with pytest.raises(NotImplementedError, match="float32 takes "
                           "head_dim up to 256.*"
                           + (above or "B-dims-2a-f32")):
            dims.flash_head_dim(d, torch.float32, what)
        with pytest.raises(NotImplementedError,
                           match=above or "float32 q takes head_dim up to "
                           "256.*B-dims-2a-f32"):
            dims.decode_q_head_dim(d, torch.float32)
        if d > 512:
            with pytest.raises(NotImplementedError, match="B-dims-2a-512+"):
                dims.decode_head_dim(d, "the CUDA append kernel")
            return
        dims.decode_head_dim(d, "the CUDA append kernel")
        dims.decode_q_head_dim(d, torch.bfloat16)
        assert dims.decode_width(d, 128) == 512
        return
    assert dims.flash_head_dim(d, torch.float32, what) == 256
    x = torch.zeros(1, 1, 3, d)
    before = dims.pad_head_dim.copies
    y = dims.pad_head_dim(x, dims.flash_head_dim(d, torch.float32, what))
    assert y.shape[-1] == 256
    assert dims.pad_head_dim.copies == before + (d != 256)
    dims.decode_q_head_dim(d, torch.float32)
    dims.decode_head_dim(d, "the CUDA append kernel")
    assert dims.decode_width(d, 128) == 256
    assert dims.decode_compiled(d, 128) == (d == 256)


def test_wide_f32_instances_fit_a_block():
    """The wide f32 instances' shared memory is the sum of their layouts
    and fits a block, where the 128 instances' tiles at 256 would not: the
    forward's q tile of 64 rows, two stages of 32-row K and V, P^T and each
    stage's kv ids; the backward's two 32-row tiles that stay, a two-stage
    ring of two, P and dS and nine rows of 32. f32 q over payloads takes
    the same wide tiles at 256."""
    assert fwd_config(torch.float32, head_dim=256) is FLASH_FWD_F32_WIDE
    assert fwd_config(torch.float32, head_dim=128) is FLASH_FWD_F32
    assert fwd_config(torch.float32, True, 256) is FLASH_FWD_F32_WIDE
    fwd = fwd_smem_bytes(FLASH_FWD_F32_WIDE, 256)
    assert fwd == (64 * 256 + 4 * 32 * 256 + 32 * 64) * 4 + 2 * 32 * 4
    assert fwd == 205056 <= SMEM_PER_BLOCK
    assert fwd_smem_bytes(FLASH_FWD_F32, 256) > SMEM_PER_BLOCK
    bwd = bwd_f32_smem_bytes(256)
    assert bwd == (6 * 32 * 256 + 2 * 32 * 32 + 9 * 32) * 4
    assert bwd == 205952 <= SMEM_PER_BLOCK
    assert (6 * 64 * 256 + 2 * 64 * 64 + 9 * 64) * 4 > SMEM_PER_BLOCK
    assert bwd_f32_smem_bytes(128) == 231680
    assert bwd_f32_config(256).block_m == 32
    assert bwd_f32_config(128).block_m == 64
    # runs of as many rows at either width
    assert bwd_f32_split(256) * 32 == bwd_f32_split(128) * 64
    # f32 pages at 256: the rings of PAGED_DECODE_F32_WIDE_WARPS warps of
    # 32-token f32 stages, q of G = 4 rows, each warp's p, the mbarriers
    warps = configs.PAGED_DECODE_F32_WIDE_WARPS
    decode = warps * 2 * 32 * 256 * 4 + 4 * 256 * 4 + warps * 32 * 4 * 4 \
        + warps * 8
    assert decode <= SMEM_PER_BLOCK
    assert configs.PAGED_DECODE_WARPS * 2 * 32 * 256 * 4 > SMEM_PER_BLOCK


@pytest.mark.parametrize("q_len,kv_len,n_bh", [
    (2048, 2048, 8), (1024, 1024, 8), (8192, 8192, 8), (4096, 32768, 2),
    (300, 300, 2), (2048, 2048, 64), (100, 9000, 8)])
def test_wide_f32_work_lists_are_bounded(q_len, kv_len, n_bh):
    """The wide f32 forward's work list at its 64-row q and 32-row kv
    tiles: every q tile's causal range covered once by its runs, the runs
    no longer than the split, at most FLASH_FWD_F32_MAX_SLOTS merge slots
    over the batch and heads, so the workspace (slots of 64 x 258 f32)
    stays under the 128 instance's 70.3 MB bound; the backward's lists at
    32-row tiles cover each tile's range in runs of bwd_f32_split(256)."""
    cfg = FLASH_FWD_F32_WIDE
    split = fwd_f32_split(q_len, kv_len, causal=True, n_bh=n_bh,
                          config=configs.FlashConfig(), cfg=cfg)
    flat, m = fwd_f32_work(q_len, kv_len, causal=True, n_bh=n_bh, cfg=cfg)
    tile, lo, hi, order = flat[:4 * m].reshape(4, m)
    first = flat[4 * m:]
    n_q = -(-q_len // cfg.block_m)
    assert first.size == n_q + 1 and sorted(order) == list(range(m))
    for t in range(n_q):
        runs = list(zip(lo[first[t]:first[t + 1]], hi[first[t]:first[t + 1]]))
        last = min((t + 1) * cfg.block_m, q_len) - 1 + kv_len - q_len
        want_hi = min(-(-kv_len // cfg.block_n), max(last, 0) // cfg.block_n
                      + 1)
        assert runs[0][0] == 0 and runs[-1][1] == want_hi
        assert all(b - a <= split for a, b in runs)
        assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    _, n_slots = fwd_f32_slots(flat, m)
    assert n_slots * n_bh <= configs.FLASH_FWD_F32_MAX_SLOTS
    ws = n_slots * n_bh * cfg.block_m * (256 + 2) * 4
    assert ws <= configs.FLASH_FWD_F32_MAX_SLOTS * 128 * 130 * 4 <= 70.3e6
    t = bwd_f32_config(256).block_m
    for table in bwd_tiles(q_len, kv_len, causal=True, window=None,
                           segment_starts=None, block_m=t, block_n=t):
        bflat, bm = f32_work(table, head_dim=256)
        blo, bhi = bflat[bm:2 * bm], bflat[2 * bm:3 * bm]
        assert (bhi - blo).max() <= bwd_f32_split(256)


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "offset"])
@pytest.mark.parametrize("d", [192, 256])
def test_wide_f32_split_merge_matches_jax(d, mask):
    """The wide f32 kernel's kv runs (64-row q tiles, 32-row kv tiles, the
    split of a small launch) merged in run order, in plain PyTorch on the
    padded tensors, against JAX's Pallas forward (interpret mode; head_dim
    192 padded to 256 lanes, q_len 640 above its XLA cutoff), out and the
    LSE at the f32 gate."""
    rng = np.random.default_rng(d + len(mask))
    b, hq, hkv, n = 1, 4, 1, 640
    q_len = 576 if mask == "offset" else n
    q, jq = _both(rng.standard_normal((b, hq, q_len, d)))
    k, jk = _both(rng.standard_normal((b, hkv, n, d)))
    v, jv = _both(rng.standard_normal((b, hkv, n, d)))
    kw = {}
    if mask == "window":
        kw["window"] = 200
    if mask == "ids":
        ids = _ids(b, n, (100, 333))
        kw["segment_ids"] = ids
    jkw = {key: ((jnp.asarray(val),) * 2 if key == "segment_ids" else val)
           for key, val in kw.items()}
    tkw = {key: ((torch.from_numpy(val),) * 2 if key == "segment_ids"
                 else val) for key, val in kw.items()}
    jout, jlse = jax_flash(jq, jk, jv, causal=True, return_lse=True, **jkw)
    pq, pk, pv = (dims.pad_head_dim(t, 256) for t in (q, k, v))
    out, lse = f32_split_merge_plain(pq, pk, pv, causal=True,
                                     sm_scale=d ** -0.5, **tkw)
    _close(dims.unpad_head_dim(out, d), jout, F32, "out")
    _close(lse, jlse, F32, "lse")
    got, got_lse = flash_attention(q, k, v, causal=True, return_lse=True,
                                   **tkw)
    _close(got, jout, F32, "entry out")
    _close(got_lse, jlse, F32, "entry lse")


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_wide_f32_slot_sums_match_jax(causal, d):
    """The wide f32 backward's slots (32-row tiles on both sides, runs of
    bwd_f32_split(256) tiles) summed in the kernels' order, in plain
    PyTorch on the padded tensors, and the port's entry, against JAX's
    flash_attention_bwd (interpret mode) at JAX's 1e-5."""
    rng = np.random.default_rng(7 * d)
    q_shape, kv_shape = (1, 4, 600, d), (1, 1, 600, d)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape, q_shape)]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    sc = d ** -0.5
    jout, jlse = _xla_attention(jq, jk, jv, None, causal, sc, True)
    want = JFB.flash_attention_bwd(jq, jk, jv, jout, jlse, jdo,
                                   causal=causal, sm_scale=sc, block_q=128,
                                   block_kv=128, interpret=True)
    q, k, v, out, lse, do = (torch.from_numpy(np.array(_np(a)))
                             for a in (jq, jk, jv, jout, jlse, jdo))
    slots = f32_slot_sums_plain(
        *(dims.pad_head_dim(t, 256) for t in (q, k, v, out)), lse,
        dims.pad_head_dim(do, 256), causal=causal, sm_scale=sc)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for name, s, g, w in zip(("dq", "dk", "dv"), slots, got, want):
        _close(dims.unpad_head_dim(s, d), w, 1e-5, f"slots {name}")
        assert bool((s[..., d:] == 0).all())
        _close(g, w, 1e-5, name)


# --- the decodes and the append ----------------------------------------------

DECODE_CASES = [(group, fmt, window) for group in (1, 4, 8)
                for fmt in ("f32", "int8") for window in (None, 100)]


def _pages(rng, hkv, np_, ps, d, fmt):
    """Fused pages of f32 K/V (fmt "f32": the model dtype's pages, the
    port's "bf16" format) or int8 pages packed by JAX, for both sides."""
    kp = rng.standard_normal((hkv, np_, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, np_, ps, d)).astype(np.float32)
    jfmt = "int8" if fmt == "int8" else "bf16"
    jpages = jpf.pack_paged_cache(jnp.asarray(kp), jnp.asarray(vp), jfmt)
    if fmt == "int8":
        return torch.from_numpy(np.array(jpages)), jpages
    return tpf.pack_paged_cache(torch.from_numpy(kp), torch.from_numpy(vp),
                                "bf16"), jpages


@pytest.mark.parametrize("group,fmt,window", DECODE_CASES)
def test_f32_fused_decode_matches_jax(group, fmt, window):
    """JAX's fused decode at head_dim 256 with f32 q (interpret mode, its q
    rows padded to 8) over f32 pages and over int8 pages packed by JAX at
    page size 64, lengths 1, a page edge, a ragged one and the full table
    (ring mode: past the ring's capacity); the port's entry and the route
    the card takes (q rows padded to the instance's G, row blocks of 4
    above it, the kernel's splits), at the f32 gates of the head_dim-128
    decode tests."""
    d = 256
    rng = np.random.default_rng(10 * group + (fmt == "int8"))
    B, hkv, ps, P = 4, 1, 64, 3
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)))
    pages, jpages = _pages(rng, hkv, NP, ps, d, fmt)
    assert pages.dtype == (torch.int8 if fmt == "int8" else torch.float32)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, ps, ps + 37, P * ps], np.int32)
    if window is not None:
        lengths = np.array([1, 150, P * ps + 9, 3 * P * ps + 30], np.int32)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps,
        window=window)
    args = (q, pages, torch.from_numpy(lengths), torch.from_numpy(table))
    out, lse = tpf.fused_paged_decode_attention(*args, page_size=ps,
                                                window=window)
    rows, blocks = dims.decode_group(group, d)
    pout, plse = tpf.fused_paged_decode_plain(
        dims.pad_group(q, hkv, rows * blocks), pages, args[2], args[3],
        page_size=ps, sm_scale=d ** -0.5, window=window, splits="kernel")
    pout = dims.unpad_group(pout, hkv, group)
    plse = dims.unpad_group(plse, hkv, group)
    for name, (o, l) in (("entry", (out, lse)), ("card route", (pout, plse))):
        assert o.dtype == torch.float32
        _close(o, jout, F32, f"{name} out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=F32, rtol=1e-5)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_f32_separate_decode_matches_jax(fmt, group):
    """B12 at head_dim 256 in f32 over one kv head: JAX's
    paged_decode_attention (interpret mode) against the port's entry and
    the card's route (padded rows, the kernel's splits)."""
    rng = np.random.default_rng(256 + group)
    B, hkv, d, ps, P = 3, 1, 256, 128, 3
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)))
    k, jk = _both(rng.standard_normal((hkv, NP, ps, d)))
    v, jv = _both(rng.standard_normal((hkv, NP, ps, d)))
    if fmt == "int8":
        k, v = TQ.quantize_int8(k, axis=-1), TQ.quantize_int8(v, axis=-1)
        jk, jv = (JQ.QuantizedTensor(values=jnp.asarray(t.values.numpy()),
                                     scales=jnp.asarray(t.scales.numpy()))
                  for t in (k, v))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, 200, P * ps], np.int32)
    jout, jlse = jax_paged(jq, jk, jv, jnp.asarray(lengths),
                           jnp.asarray(table), interpret=True)
    tl, tt = torch.from_numpy(lengths), torch.from_numpy(table)
    out, lse = paged_decode_attention(q, k, v, tl, tt)
    rows, blocks = dims.decode_group(group, d)
    pout, plse = paged_decode_plain(dims.pad_group(q, hkv, rows * blocks),
                                    k, v, tl, tt, sm_scale=d ** -0.5,
                                    splits="kernel")
    for o, l in ((out, lse), (dims.unpad_group(pout, hkv, group),
                              dims.unpad_group(plse, hkv, group))):
        _close(o, jout, F32, "out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=F32, rtol=1e-5)


@pytest.mark.parametrize("fmt", ["f32", "int8"])
@pytest.mark.parametrize("ps", [64, 128, 256])
def test_f32_append_matches_jax(ps, fmt):
    """The append of f32 rows at head_dim 256 into f32 pages and into int8
    pages against the JAX engine's append (`_append_rows_scatter`) bit for
    bit: the f32 rows as they are; the int8 rows, their amax and rounding
    and the scale bytes."""
    d = 256
    rng = np.random.default_rng(ps + (fmt == "int8"))
    B, hkv, npages = 3, 1, 6
    jfmt = "int8" if fmt == "int8" else "bf16"
    prows = tpf.page_rows(ps, d, jfmt)
    raw = rng.integers(-5, 5, (hkv, npages, prows, d))
    if fmt == "int8":
        pages = torch.from_numpy(raw.astype(np.int8))
        jpages = jnp.asarray(raw, jnp.int8)
    else:
        pages, jpages = _both(raw)
    k_new, jk = _both(rng.standard_normal((B, hkv, d)) * 3)
    v_new, jv = _both(rng.standard_normal((B, hkv, d)))
    ids = np.array([0, 3, 5], np.int32)
    rows = np.array([0, ps // 2 + 17, ps - 1], np.int32)
    got = tpf.fused_page_append(pages, k_new, v_new, torch.from_numpy(ids),
                                torch.from_numpy(rows), page_size=ps)
    scatter = np.asarray(JI._append_rows_scatter(
        jpages, jk, jv, jnp.asarray(ids), jnp.asarray(rows), page_size=ps,
        fmt=jfmt))
    assert got.dtype == (torch.int8 if fmt == "int8" else torch.float32)
    np.testing.assert_array_equal(
        got.numpy().view(np.int8 if fmt == "int8" else np.int32),
        scatter.view(np.int8 if fmt == "int8" else np.int32))


# --- the model end to end ----------------------------------------------------

WIDTHS = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
              n_kv_heads=1, d_head=256, d_ff=256)


def test_f32_int8_engine_greedy_tokens_match_jax():
    """Two f32 layers at head_dim 256, 4 q heads over 1 kv head, over int8
    pages (page size 128 <= head_dim, JAX's int8 page rule), JAX's weights
    carried over by params_from_jax: three prompts through two slots,
    chunked and per-token decode; greedy tokens equal JAX's
    InferenceEngine's."""
    jcfg = JT.ModelConfig(**WIDTHS, dtype=jnp.float32, attn_impl="flash")
    tcfg = TT.ModelConfig(**WIDTHS, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(17))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(17)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (5, 130, 30)]
    kw = dict(num_pages=16, page_size=128, max_seqs=2, pages_per_seq=4,
              kv_format="int8")
    jeng = JEngine(jcfg, jp, **kw)
    teng = TEngine(tcfg, tp, **kw, device="cpu")
    want = jeng.generate(prompts, max_new_tokens=10, chunk=4)
    got = teng.generate(prompts, max_new_tokens=10, chunk=4)
    assert tcfg.group == 4 and teng.cache.pages[0].dtype == torch.int8
    assert got == want


def _jax_leaves(tree) -> list:
    """JAX params in the port's param_leaves order, stacked layers split."""
    layers = tree["layers"]
    n = layers["wq"].shape[0]
    return [np.asarray(tree["embed"]),
            *(np.asarray(layers[name][i]) for i in range(n)
              for name in sorted(layers)),
            np.asarray(tree["final_norm"]), np.asarray(tree["lm_head"])]


def test_f32_train_step_matches_jax():
    """The f32 train step at head_dim 256 (two layers, 4 q heads over 1 kv
    head, JAX's weights via params_from_jax, attn_impl "flash" on both
    sides): the loss and every gradient of one step within 1e-5 of JAX's,
    then three SGD steps (the update linear in the gradients), the losses
    and the parameters within 1e-5 of JAX's train step."""
    jcfg = JT.ModelConfig(**WIDTHS, dtype=jnp.float32, attn_impl="flash")
    tcfg = TT.ModelConfig(**WIDTHS, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(3))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")

    def tokens(seed):
        return np.random.default_rng(seed).integers(
            0, WIDTHS["vocab_size"], (2, 96)).astype(np.int32)

    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jnp.asarray(tokens(0))))(jp)
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss = TT.loss_fn(tcfg, tp, torch.from_numpy(tokens(0)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    for i, (g, w) in enumerate(zip([t.grad for t in leaves],
                                   _jax_leaves(jgrads))):
        _close(g, w, 1e-5, f"grad {i}")

    import optax

    jstep, jinit = jax_make_train_step(jcfg, make_mesh(1),
                                       optimizer=optax.sgd(1e-2))
    jparams, jopt = jinit(jp)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    step, init = make_train_step(
        tcfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2),
        device="cpu")
    params, opt = init(tp)
    for i in range(3):
        toks = tokens(10 + i)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(toks))
        params, opt, tl = step(params, opt, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=1e-5)
    for i, (g, w) in enumerate(zip(param_leaves(params),
                                   _jax_leaves(jparams))):
        _close(g, w, 1e-5, f"param {i}")


def test_wide_f32_split_merge_matches_plain():
    """The wide f32 kernel's run layout (f32_split_merge_plain at its 64 x
    32 tiles) at batch 2, group 4, 300 rows (not a multiple of either
    tile) is the plain forward's at the f32 gate."""
    rng = np.random.default_rng(300)
    q = torch.from_numpy(rng.standard_normal((2, 4, 300, 256)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 1, 300, 256)).astype(
        np.float32)) for _ in range(2))
    out, lse = f32_split_merge_plain(q, k, v, causal=True, sm_scale=1 / 16)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True,
                                         sm_scale=1 / 16, return_lse=True)
    _close(out, ref, F32, "out")
    _close(lse, ref_lse, F32, "lse")
