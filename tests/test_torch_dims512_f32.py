"""Head dims 257-512 on the f32 serving path against the JAX package, on
the CPU.

An f32 model at head dims in (256, 512] serves in JAX: its forward pads
head_dim to whole 128-lane tiles (its f32 tables hold tiles at 384) and
its decodes take q of any dtype at any width, over f32 and int8 pages. The
port's f32 forward pads (256, 512] to 512, its instance of width 512 (32
q rows and 32 kv rows a tile, K and V in one buffer each), the decodes
with f32 q read the pages in place on their instances of width 512 (f32
pages in 16-token chunks); the f32 backward there still raises
(tests/test_torch_dims.py holds the rule). Here the same numpy inputs,
made from a seed, go through the JAX function (its Pallas kernels in
interpret mode) and through the port: its public entry (the plain versions
on the CPU) and the layouts the card's kernels compute, in plain PyTorch:
the f32 forward's kv runs merged in order (`f32_split_merge_plain`) at the
width-512 tiles on the padded tensors, and the decodes' padded rows and
splits. Gates: f32 2e-5 (utils/testing.py), the LSE also at rtol 1e-5,
fp16 out at its own rounding (1e-3), the append bit for bit; a head_dim-512
f32 engine's greedy tokens equal to JAX's engine's. The host-side layouts
of the instance of width 512 are held here too: its shared memory, work
lists and merge workspace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models import inference as JI
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.models.engine import InferenceEngine as JEngine
from tiny_flash_attention_tpu.ops import paged_fused as jpf
from tiny_flash_attention_tpu.ops import quant as JQ
from tiny_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from tiny_flash_attention_tpu.ops.flash_rowloop import (
    flash_attention_rowloop as jax_rowloop)
from tiny_flash_attention_tpu.ops.paged import (
    paged_decode_attention as jax_paged)
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine as TEngine)
from tiny_flash_attention_tpu_torch.ops import configs, dims
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.ops import quant as TQ
from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_FWD_F32_512, FLASH_FWD_F32_WIDE, SMEM_PER_BLOCK, fwd_smem_bytes)
from tiny_flash_attention_tpu_torch.ops.flash import (
    f32_split_merge_plain, flash_attention, fwd_config, fwd_f32_slots,
    fwd_f32_split, fwd_f32_work)
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop)
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
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


# --- the instance of width 512: its layouts ------------------------------------


def test_f32_512_instance_fits_a_block():
    """The f32 instance of width 512 takes every head_dim in (256, 512]
    (padded to 512) at 32-row q and kv tiles; its shared memory, q, one K
    and one V buffer, P^T and the kv ids, is 200,832 bytes and fits a
    block, where the wide instance's tiles at 512 would not; its merge
    slots (32 x 514 floats) keep the workspace under 70 MB; f32 pages at
    512 in 16-token chunks fit a block of PAGED_DECODE_512_WARPS warps,
    where 32-token chunks would not. The quantized forward has no
    instance there."""
    for d in (264, 384, 448, 512):
        assert fwd_config(torch.float32, head_dim=d) is FLASH_FWD_F32_512
    assert fwd_config(torch.float32, head_dim=256) is FLASH_FWD_F32_WIDE
    cfg = FLASH_FWD_F32_512
    assert (cfg.block_m, cfg.block_n, cfg.threads) == (32, 32, 256)
    smem = fwd_smem_bytes(cfg, 512)
    assert smem == (32 * 512 + 2 * 32 * 512 + 32 * 32 + 32) * 4
    assert smem == 200832 <= SMEM_PER_BLOCK
    assert fwd_smem_bytes(FLASH_FWD_F32_WIDE, 512) > SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        fwd_smem_bytes(cfg, 512, quantized=True)
    ws = configs.FLASH_FWD_F32_MAX_SLOTS * cfg.block_m * (512 + 2) * 4
    assert ws == 69476352 < 70e6
    # O at 32 x 512 over 256 threads: 64 registers a thread, as at 128
    assert cfg.block_m * 512 // cfg.threads == 64
    # the runs start from as many kv columns as f32_split's
    assert fwd_f32_split(8192, 8192, causal=True, n_bh=1,
                         config=configs.FlashConfig(), cfg=cfg) * 32 >= \
        configs.FlashConfig().f32_split * 64
    warps = configs.PAGED_DECODE_512_WARPS
    f32_pages = warps * 2 * 16 * 512 * 4 + 2 * 512 * 4 + warps * 16 * 2 * 4 \
        + warps * 8
    assert f32_pages <= SMEM_PER_BLOCK
    assert warps * 2 * 32 * 512 * 4 > SMEM_PER_BLOCK


@pytest.mark.parametrize("q_len,kv_len,n_bh", [
    (2048, 2048, 64), (2048, 2048, 8), (1024, 1024, 1), (8192, 8192, 1),
    (300, 300, 2), (100, 9000, 8)])
def test_f32_512_work_lists_are_bounded(q_len, kv_len, n_bh):
    """The f32 forward's work list at the width-512 instance's tiles: every
    q tile's causal range covered once by its runs, in order, none longer
    than the split, at most FLASH_FWD_F32_MAX_SLOTS merge slots over the
    batch and heads (so the workspace stays under 70 MB); at
    DeepSeek-V4-Flash's prefill (64 heads over 2048 rows) one run a q
    tile and no workspace."""
    cfg = FLASH_FWD_F32_512
    split = fwd_f32_split(q_len, kv_len, causal=True, n_bh=n_bh,
                          config=configs.FlashConfig(), cfg=cfg)
    flat, m = fwd_f32_work(q_len, kv_len, causal=True, n_bh=n_bh, cfg=cfg)
    _, lo, hi, order = flat[:4 * m].reshape(4, m)
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
    assert n_slots * n_bh * cfg.block_m * (512 + 2) * 4 < 70e6
    if n_bh == 64:
        assert n_slots == 0 and m == n_q


# --- the flash forward and the row loop ------------------------------------------

# (head_dim, group, mask): every head_dim with groups 1 and 8, each mask
# ("starts": the ids with their segment_starts), group 64 at one case
FWD_CASES = [(264, 1, "causal"), (264, 8, "starts"), (384, 1, "full"),
             (384, 8, "window"), (512, 1, "window"), (512, 8, "causal"),
             (512, 64, "starts")]


@pytest.mark.parametrize("d,group,mask", FWD_CASES)
def test_f32_flash_forward_matches_jax(d, group, mask):
    """JAX's flash_attention in f32 at head dims 264-512 (its Pallas kernel
    in interpret mode above its XLA cutoff; 264 padded to 384 lanes, group
    64 at a short length, under the cutoff) under each mask; the port's
    entry and the card's route (the kv runs of the width-512 instance
    merged in order, on q, k and v padded to 512) hold to it, out and the
    LSE at the f32 gate."""
    rng = np.random.default_rng(d * 10 + group)
    b, hkv = 1, 2 if group == 1 else 1
    n = 160 if group == 64 else 576
    q, jq = _both(rng.standard_normal((b, hkv * group, n, d)))
    k, jk = _both(rng.standard_normal((b, hkv, n, d)))
    v, jv = _both(rng.standard_normal((b, hkv, n, d)))
    causal = mask != "full"
    kw = {}
    if mask == "window":
        kw["window"] = 200
    if mask == "starts":
        ids = _ids(b, n, (100, 133))
        kw["segment_ids"] = (ids, ids)
    jout, jlse = jax_flash(
        jq, jk, jv, causal=causal, return_lse=True,
        **{key: (tuple(jnp.asarray(x) for x in val)
                 if key == "segment_ids" else val)
           for key, val in kw.items()})
    tkw = {key: (tuple(torch.from_numpy(x) for x in val)
                 if key == "segment_ids" else val)
           for key, val in kw.items()}
    if mask == "starts":
        tkw["segment_starts"] = (0, 100, 133)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True,
                               **tkw)
    _close(out, jout, F32, "entry out")
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=F32, rtol=1e-5)
    assert dims.flash_head_dim(d, torch.float32, "the kernel") == 512
    pout, plse = f32_split_merge_plain(
        *(dims.pad_head_dim(t, 512) for t in (q, k, v)), causal=causal,
        sm_scale=d ** -0.5, **tkw)
    assert bool((pout[..., d:] == 0).all())
    _close(dims.unpad_head_dim(pout, d), jout, F32, "card route out")
    np.testing.assert_allclose(_np(plse), _np(jlse), atol=F32, rtol=1e-5)


def test_f32_rowloop_matches_jax():
    """JAX's jagged row loop in f32 (interpret mode) at head_dim 448,
    three rows of lengths 192, 65 and 1, group 4; the port's row loop holds
    to it below each length and writes empty rows past it."""
    rng = np.random.default_rng(448)
    q, jq = _both(rng.standard_normal((3, 4, 192, 448)))
    k, jk = _both(rng.standard_normal((3, 1, 192, 448)))
    v, jv = _both(rng.standard_normal((3, 1, 192, 448)))
    lens = [192, 65, 1]
    out, lse = flash_attention_rowloop(q, k, v, causal=True,
                                       seq_lengths=lens)
    jout, jlse = jax_rowloop(jq, jk, jv, causal=True,
                             seq_lengths=jnp.asarray(lens, jnp.int32))
    for b, L in enumerate(lens):
        _close(out[b, :, :L], jout[b, :, :L], F32, f"out row {b}")
        _close(lse[b, :, :L], jlse[b, :, :L], F32, f"lse row {b}")
        assert torch.all(out[b, :, L:] == 0)


def test_fp16_forward_matches_jax():
    """fp16 rides the f32 instances: at head_dim 384 (padded to 512 on the
    card) the port's fp16 out is JAX's f32 attention of the same fp16
    inputs within fp16's rounding of out (1e-3), its LSE at the f32
    gate."""
    rng = np.random.default_rng(16)
    arrs = [rng.standard_normal(s).astype(np.float16).astype(np.float32)
            for s in ((1, 8, 576, 384), (1, 1, 576, 384), (1, 1, 576, 384))]
    jout, jlse = jax_flash(*(jnp.asarray(a) for a in arrs), causal=True,
                           return_lse=True)
    q, k, v = (torch.from_numpy(a).half() for a in arrs)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    assert out.dtype == torch.float16
    _close(out, jout, 1e-3, "fp16 out")
    _close(lse, jlse, F32, "fp16 lse")


# --- the decodes and the append ---------------------------------------------------

# (head_dim, group, page size, page format, window): every head_dim with
# every page size, the groups by turn, each format and the ring
DECODE_CASES = [(300, 1, 1, "f32", None), (300, 8, 48, "int8", 100),
                (300, 64, 128, "f32", None), (384, 8, 64, "f32", 100),
                (384, 1, 128, "int8", None), (384, 64, 48, "f32", None),
                (512, 64, 64, "int8", None), (512, 8, 128, "f32", 100),
                (512, 1, 1, "int8", None), (512, 8, 48, "f32", None)]


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


@pytest.mark.parametrize("d,group,ps,fmt,window", DECODE_CASES)
def test_f32_fused_decode_matches_jax(d, group, ps, fmt, window):
    """JAX's fused decode with f32 q (interpret mode, its q rows padded to
    8) over f32 pages and int8 pages packed by JAX, lengths 1, a page
    edge, a ragged one and the full table (ring mode: past the ring's
    capacity); the port's entry and the card's route (q rows padded to the
    row blocks of DECODE_TOP_512, the kernel's splits), out in f32 at the
    f32 gate."""
    rng = np.random.default_rng(d + group + ps)
    B, hkv = 4, 1
    P = 24 if ps == 1 else 3
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)))
    pages, jpages = _pages(rng, hkv, NP, ps, d, fmt)
    assert pages.dtype == (torch.int8 if fmt == "int8" else torch.float32)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, ps, ps + 7, P * ps], np.int32)
    if window is not None:
        lengths = np.array([1, 150, P * ps + 9, 3 * P * ps + 30], np.int32)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps,
        window=window)
    args = (q, pages, torch.from_numpy(lengths), torch.from_numpy(table))
    out, lse = tpf.fused_paged_decode_attention(*args, page_size=ps,
                                                window=window)
    rows, blocks = dims.decode_group(group, d)
    assert rows <= dims.DECODE_TOP_512
    pout, plse = tpf.fused_paged_decode_plain(
        dims.pad_group(q, hkv, rows * blocks), pages, args[2], args[3],
        page_size=ps, sm_scale=d ** -0.5, window=window, splits="kernel")
    pout = dims.unpad_group(pout, hkv, group)
    plse = dims.unpad_group(plse, hkv, group)
    for name, (o, l) in (("entry", (out, lse)), ("card route", (pout, plse))):
        assert o.dtype == torch.float32
        _close(o, jout, F32, f"{name} out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=F32, rtol=1e-5)


# (head_dim, group, page size, format): int8 separate pages at a multiple
# of 128 (JAX's rule)
SEPARATE_CASES = [(300, 8, 48, "f32"), (384, 64, 64, "f32"),
                  (512, 1, 128, "int8"), (512, 8, 16, "f32")]


@pytest.mark.parametrize("d,group,ps,fmt", SEPARATE_CASES)
def test_f32_separate_decode_matches_jax(d, group, ps, fmt):
    """B12 with f32 q over one kv head: JAX's paged_decode_attention
    (interpret mode) over f32 and int8 pages against the port's entry and
    the card's route (padded rows, the kernel's splits), at the f32
    gate."""
    rng = np.random.default_rng(d + group + ps + 1)
    B, hkv, P = 2, 1, 2 if ps >= 128 else 5
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
    lengths = np.array([ps + 3, P * ps], np.int32)
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
        assert o.dtype == torch.float32
        _close(o, jout, F32, "out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=F32, rtol=1e-5)


@pytest.mark.parametrize("ps", [64, 128])
def test_f32_append_matches_jax(ps):
    """The append of f32 rows at head_dim 512 into f32 pages against the
    JAX engine's append (`_append_rows_scatter`) bit for bit."""
    d = 512
    rng = np.random.default_rng(ps + 512)
    B, hkv, npages = 3, 1, 6
    prows = tpf.page_rows(ps, d, "bf16")
    pages, jpages = _both(rng.integers(-5, 5, (hkv, npages, prows, d)))
    k_new, jk = _both(rng.standard_normal((B, hkv, d)) * 3)
    v_new, jv = _both(rng.standard_normal((B, hkv, d)))
    ids = np.array([0, 3, 5], np.int32)
    rows = np.array([0, ps // 2 + 17, ps - 1], np.int32)
    got = tpf.fused_page_append(pages, k_new, v_new, torch.from_numpy(ids),
                                torch.from_numpy(rows), page_size=ps)
    scatter = np.asarray(JI._append_rows_scatter(
        jpages, jk, jv, jnp.asarray(ids), jnp.asarray(rows), page_size=ps,
        fmt="bf16"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  scatter.view(np.int32))


# --- the model end to end ----------------------------------------------------------


@pytest.mark.parametrize("fmt,ps", [("bf16", 64), ("int8", 128)])
def test_f32_engine_greedy_tokens_match_jax(fmt, ps):
    """Two f32 layers at head_dim 512, 8 q heads over 1 kv head
    (DeepSeek-V4-Flash's shape of attention, cut in width), JAX's weights
    carried over by params_from_jax, over f32 pages (the model dtype's
    "bf16" format) and int8 pages: three prompts through two slots,
    chunked and per-token decode; greedy tokens equal JAX's
    InferenceEngine's."""
    widths = dict(vocab_size=256, d_model=256, n_layers=2, n_q_heads=8,
                  n_kv_heads=1, d_head=512, d_ff=256)
    jcfg = JT.ModelConfig(**widths, dtype=jnp.float32, attn_impl="flash")
    tcfg = TT.ModelConfig(**widths, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(26))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(26)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (70, 9, 140)]
    kw = dict(num_pages=16 * 64 // ps, page_size=ps, max_seqs=2,
              pages_per_seq=6 * 64 // ps, kv_format=fmt)
    want = JEngine(jcfg, jp, **kw).generate(prompts, max_new_tokens=6,
                                            chunk=3)
    teng = TEngine(tcfg, tp, **kw, device="cpu")
    got = teng.generate(prompts, max_new_tokens=6, chunk=3)
    assert teng.cache.pages[0].dtype == (torch.int8 if fmt == "int8"
                                         else torch.float32)
    assert got == want
