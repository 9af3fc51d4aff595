"""Head dims 257-512 against the JAX package, on the CPU: the serving path.

The JAX package pads any head_dim to whole 128-lane tiles in its forward
(tables for 384, 128 x 128 tiles above) and its decodes and append take any
width. The port serves head dims in (256, 512]: the bf16 forward over bf16
K/V reads any multiple of 8 there in place on its instance of width 512
(others pad to 512), the jagged row loop with it; the decodes (fused and
separate pages, bf16 q over bf16 and int8 pages, the ring) and the append
(every page format) on their instances of width 512, which read the pages
in place; the decode covers a GQA group by row blocks of
dims.DECODE_TOP_512 q rows. The backward at these head dims is
tests/test_torch_dims512_train.py's; f32 and the quantized forward stop at
256 (tests/test_torch_dims.py holds their refusals).

Here the same numpy inputs, made from a seed, go through the JAX function
(its Pallas kernels in interpret mode) and through the port: its public
entry (the plain version at the true head_dim, on the CPU, what the
in-place kernels compute) and the route the card takes (the flash forward
padded to 512; the decode's q rows padded to its row blocks at the
kernel's splits). Gates: bf16 2e-2 (utils/testing.py), the separate decode
in f32 q at 1e-4, the append bit for bit. Two small engines at head_dim
512 (8 q heads over 1 kv head, 2 layers) carry JAX's weights over with
params_from_jax, over f32 and int8 pages: greedy tokens equal to JAX's
engine's, prefill logits within chip_smoke.py's engine gate.
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
from tiny_flash_attention_tpu_torch.models import inference as TI
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine as TEngine)
from tiny_flash_attention_tpu_torch.ops import configs, dims
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.ops import quant as TQ
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain, fwd_config)
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop)
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
BF16 = torch.bfloat16
# chip_smoke.py's ENGINE_LOGIT_GATE: a logit's error over the largest |logit|
ENGINE_LOGIT_GATE = 1.5e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.0e}"


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a).to(dtype), jnp.asarray(a, _JNP[dtype])


def _ids(b, n, bounds):
    ids = np.zeros((b, n), np.int32)
    for i, x in enumerate(bounds):
        ids[:, x:] = i + 1
    return ids


# --- the instances ------------------------------------------------------------


def test_wider_tiles_and_groups():
    """B1's instance of width 512: 64-row q and 32-row kv tiles in two
    stages, 197,960 bytes of shared memory (it fits a block; 64-row kv
    tiles would not leave room for two stages), for bf16 over bf16 K/V
    alone; the decodes' groups stop at DECODE_TOP_512 above 256, a group of
    64 (DeepSeek-V4-Flash's) as row blocks of it."""
    cfg = fwd_config(BF16, False, 512)
    assert cfg is configs.FLASH_FWD_BF16_512
    assert fwd_config(BF16, False, 264) is cfg
    assert fwd_config(BF16, False, 256) is configs.FLASH_FWD_BF16_WIDE
    assert (cfg.block_m, cfg.block_n) == (64, 32)
    smem = configs.fwd_smem_bytes(cfg, 512)
    assert smem == 197960 <= configs.SMEM_PER_BLOCK
    # the same ring of 64-row kv tiles would not fit
    assert 64 * 512 * 2 + 2 * 2 * 64 * 512 * 2 > configs.SMEM_PER_BLOCK
    top = dims.DECODE_TOP_512
    assert dims.decode_group(64, 512) == (top, 64 // top)
    assert dims.decode_group(8, 300) == (top, 8 // top)
    assert dims.decode_group(1, 384) == (1, 1)
    assert dims.decode_width(384, 48) == 512
    assert dims.decode_compiled(512, 64) and not dims.decode_compiled(512, 48)
    assert not dims.decode_compiled(384, 64)
    # a warp's bf16 stage at 512 is 64 KiB: the blocks take fewer warps
    assert configs.PAGED_DECODE_512_WARPS * 2 * 32 * 512 * 2 \
        <= configs.SMEM_PER_BLOCK


# --- the flash forward and the row loop -----------------------------------------

FWD_CASES = [(264, 1, "causal"), (264, 8, "ids"), (384, 1, "window"),
             (384, 8, "causal"), (512, 1, "ids"), (512, 8, "window"),
             (392, 64, "causal"), (512, 64, "ids")]


@pytest.mark.parametrize("d,group,mask", FWD_CASES)
def test_flash_forward_matches_jax(d, group, mask):
    """JAX's flash_attention at head dims 264-512 (its Pallas kernel in
    interpret mode above its XLA cutoff; 384 and 512 whole 128-lane tiles,
    264 and 392 padded) under each mask, groups 1, 8 and 64 (64 at a short
    length, under the cutoff); the port's entry (at the true head_dim, as
    the kernel of width 512 reads it in place) and its padded route to 512
    hold to it, out and the LSE."""
    rng = np.random.default_rng(d * 10 + group)
    b, hkv = 1, 2 if group == 1 else 1
    n = 160 if group == 64 else 576
    q, jq = _both(rng.standard_normal((b, hkv * group, n, d)), BF16)
    k, jk = _both(rng.standard_normal((b, hkv, n, d)), BF16)
    v, jv = _both(rng.standard_normal((b, hkv, n, d)), BF16)
    kw = {}
    if mask == "window":
        kw["window"] = 200
    if mask == "ids":
        ids = _ids(b, n, (100, 133))
        kw["segment_ids"] = (ids, ids)
    jout, jlse = jax_flash(
        jq, jk, jv, causal=True, return_lse=True,
        **{key: (tuple(jnp.asarray(x) for x in val)
                 if key == "segment_ids" else val)
           for key, val in kw.items()})
    tkw = {key: (tuple(torch.from_numpy(x) for x in val)
                 if key == "segment_ids" else val)
           for key, val in kw.items()}
    if mask == "ids":
        tkw["segment_starts"] = (0, 100, 133)
    atol = tolerance_for(BF16)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, **tkw)
    _close(out, jout, atol, "out")
    _close(lse, jlse, atol, "lse")
    tkw.pop("segment_starts", None)
    pout, plse = flash_attention_plain(
        *(dims.pad_head_dim(t, 512) for t in (q, k, v)), causal=True,
        sm_scale=d ** -0.5, return_lse=True, **tkw)
    _close(dims.unpad_head_dim(pout, d), jout, atol, "padded out")
    _close(plse, jlse, atol, "padded lse")


@pytest.mark.parametrize("d", [320, 512])
def test_rowloop_matches_jax(d):
    """JAX's jagged row loop (interpret mode) at head dims 320 and 512,
    three rows of lengths 192, 65 and 1, group 4; the port's row loop
    holds to it below each length and writes empty rows past it."""
    rng = np.random.default_rng(d)
    q, jq = _both(rng.standard_normal((3, 4, 192, d)), BF16)
    k, jk = _both(rng.standard_normal((3, 1, 192, d)), BF16)
    v, jv = _both(rng.standard_normal((3, 1, 192, d)), BF16)
    lens = [192, 65, 1]
    out, lse = flash_attention_rowloop(q, k, v, causal=True,
                                       seq_lengths=lens)
    jout, jlse = jax_rowloop(jq, jk, jv, causal=True,
                             seq_lengths=jnp.asarray(lens, jnp.int32))
    atol = tolerance_for(BF16)
    for b, L in enumerate(lens):
        _close(out[b, :, :L], jout[b, :, :L], atol, f"out row {b}")
        _close(lse[b, :, :L], jlse[b, :, :L], atol, f"lse row {b}")
        assert torch.all(out[b, :, L:] == 0)


# --- the decodes and the append -------------------------------------------------

# (head_dim, group, page size, page format, window): every head_dim with
# every group and page size by turn, each format and the ring
DECODE_CASES = [(300, 1, 16, "bf16", None), (300, 8, 48, "int8", None),
                (300, 64, 128, "bf16", 100), (384, 1, 48, "bf16", 100),
                (384, 8, 128, "int8", None), (384, 64, 16, "int8", 100),
                (512, 1, 128, "int8", 100), (512, 8, 16, "bf16", None),
                (512, 64, 48, "bf16", None), (512, 8, 128, "bf16", 100)]


def _padded_decode(q, pages, lengths, table, hkv, **kw):
    """The decode as the card runs it above head_dim 256: q rows padded to
    the instance's row blocks, the kernel's splits, unpadded."""
    group = q.shape[1] // hkv
    rows, blocks = dims.decode_group(group, q.shape[-1])
    out, lse = tpf.fused_paged_decode_plain(
        dims.pad_group(q, hkv, rows * blocks), pages, lengths, table,
        splits="kernel", **kw)
    return dims.unpad_group(out, hkv, group), dims.unpad_group(lse, hkv,
                                                                group)


@pytest.mark.parametrize("d,group,ps,fmt,window", DECODE_CASES)
def test_fused_decode_matches_jax(d, group, ps, fmt, window):
    """JAX's fused decode (interpret mode, its q rows padded to 8) over
    bf16 or int8 pages packed by JAX, lengths 1, a page edge, a ragged one
    and the full table (ring mode: past the ring's capacity); the port's
    entry and its padded route."""
    rng = np.random.default_rng(d + group + ps)
    B, hkv, P = 4, 1, 3 if ps >= 48 else 8
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)), BF16)
    kp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    if fmt == "int8":
        jpages = jpf.pack_paged_cache(jnp.asarray(kp), jnp.asarray(vp),
                                      "int8")
        pages = torch.from_numpy(np.array(jpages))
    else:
        kt, jk = _both(kp, BF16)
        vt, jv = _both(vp, BF16)
        pages = tpf.pack_paged_cache(kt, vt, "bf16")
        jpages = jpf.pack_paged_cache(jk, jv, "bf16")
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, ps, ps + 7, P * ps], np.int32)
    if window is not None:
        window = min(window, P * ps)
        lengths = np.array([1, 150, P * ps + 9, 3 * P * ps + 30], np.int32)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps,
        window=window)
    args = (q, pages, torch.from_numpy(lengths), torch.from_numpy(table))
    atol = tolerance_for(BF16)
    out, lse = tpf.fused_paged_decode_attention(*args, page_size=ps,
                                                window=window)
    pout, plse = _padded_decode(*args, hkv, page_size=ps,
                                sm_scale=d ** -0.5, window=window)
    for name, (o, l) in (("entry", (out, lse)), ("padded", (pout, plse))):
        _close(o, jout, atol, f"{name} out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=atol, rtol=1e-5)


# (head_dim, group, page size, format): int8 separate pages at a multiple
# of 128 (JAX's rule)
SEPARATE_CASES = [(300, 64, 16, "bf16"), (384, 1, 48, "bf16"),
                  (512, 8, 128, "bf16"), (300, 8, 128, "int8"),
                  (512, 64, 128, "int8")]


@pytest.mark.parametrize("d,group,ps,fmt", SEPARATE_CASES)
def test_separate_decode_matches_jax(d, group, ps, fmt):
    """B12 over one kv head: JAX's paged_decode_attention (interpret mode)
    against the port's entry and its padded route, f32 q at 1e-4."""
    rng = np.random.default_rng(d + group + ps)
    B, hkv, P = 2, 1, 2 if ps >= 128 else 5
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)), torch.float32)
    kp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    k, v = torch.from_numpy(kp), torch.from_numpy(vp)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
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
        _close(o, jout, 1e-4, "out")
        _close(l, jlse, 1e-4, "lse")


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("d,ps", [(300, 48), (384, 128), (512, 128),
                                  (512, 1024)])
def test_append_matches_jax(d, ps, fmt):
    """The append at head dims 300-512 against the JAX engine's append
    (`_append_rows_scatter`) bit for bit: int8 rows, their amax and
    rounding and the scale bytes (JAX's scale-row layout, 4 * (row / D),
    two groups of scale rows at page size 1024)."""
    rng = np.random.default_rng(d + ps)
    B, hkv, npages = 3, 2, 6
    prows = tpf.page_rows(ps, d, fmt)
    raw = rng.integers(-5, 5, (hkv, npages, prows, d))
    if fmt == "int8":
        pages = torch.from_numpy(raw.astype(np.int8))
        jpages = jnp.asarray(raw, jnp.int8)
    else:
        pages, jpages = _both(raw, BF16)
    k_new, jk = _both(rng.standard_normal((B, hkv, d)) * 3, BF16)
    v_new, jv = _both(rng.standard_normal((B, hkv, d)), BF16)
    ids = np.array([0, 3, 5], np.int32)
    rows = np.array([0, ps // 2 + 1, ps - 1], np.int32)
    got = tpf.fused_page_append(pages, k_new, v_new, torch.from_numpy(ids),
                                torch.from_numpy(rows), page_size=ps)
    scatter = np.asarray(JI._append_rows_scatter(
        jpages, jk, jv, jnp.asarray(ids), jnp.asarray(rows), page_size=ps,
        fmt=fmt))
    if fmt == "bf16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      scatter.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), scatter)


# --- the engine end to end ------------------------------------------------------


@pytest.mark.parametrize("fmt,ps", [("bf16", 64), ("int8", 128)])
def test_engine_greedy_tokens_match_jax(fmt, ps):
    """Two layers at head_dim 512, 8 q heads over 1 kv head (n_q_heads *
    d_head != d_model, as in DeepSeek-V4-Flash), JAX's weights carried over
    by params_from_jax, over pages of the model's dtype and int8 pages:
    three prompts through two slots, chunked and per-token decode; greedy
    tokens equal JAX's InferenceEngine's; the prefill logits within the
    engine gate of JAX's."""
    widths = dict(vocab_size=256, d_model=256, n_layers=2, n_q_heads=8,
                  n_kv_heads=1, d_head=512, d_ff=256)
    jcfg = JT.ModelConfig(**widths, dtype=jnp.float32, attn_impl="flash")
    tcfg = TT.ModelConfig(**widths, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(512))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(512)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (5, 130, 30)]
    kw = dict(num_pages=16 * 64 // ps, page_size=ps, max_seqs=2,
              pages_per_seq=6 * 64 // ps, kv_format=fmt)
    want = JEngine(jcfg, jp, **kw).generate(prompts, max_new_tokens=8,
                                            chunk=4)
    got = TEngine(tcfg, tp, **kw, device="cpu").generate(
        prompts, max_new_tokens=8, chunk=4)
    assert tcfg.group == 8
    assert got == want
    toks = np.asarray([prompts[1]], np.int32)
    tl = TI.prefill_forward(tcfg, tp, torch.from_numpy(toks))[0]
    jl = JI.prefill_forward(jcfg, jp, jnp.asarray(toks))[0]
    scale = float(np.max(np.abs(_np(jl))))
    _close(tl, jl, ENGINE_LOGIT_GATE * scale, "prefill logits")


@pytest.mark.parametrize("d", [256, 264, 512])
def test_bare_gate_takes_one_bf16_ulp_above_256(d):
    """flash_gate's out gate against the unfolded plain version: above
    head_dim 256 an element may be one bf16 ulp of its |plain| past the
    bf16 gate (2.34375e-2 at a plain -1.9921875), never two; at 256 the
    gate is 2e-2 as it stands. The gates at the fold see the same
    outputs."""
    from tiny_flash_attention_tpu_torch.utils.testing import (
        bf16_ulp, flash_gate)
    ref = torch.zeros(1, 1, 2, d, dtype=BF16)
    ref[..., 0], ref[..., 1] = -1.9921875, 3.0
    lse = torch.zeros(1, 1, 2)
    q = torch.zeros(1, 1, 2, d, dtype=BF16)
    for past, want in ((1, d > 256), (2, False)):
        out = ref.clone()
        out[..., 0] = ref[..., 0].float() - 2e-2 - past * bf16_ulp(
            ref[..., 0])
        errs, folded, ok = flash_gate(out, lse, lambda x, sc: (ref, lse),
                                      q, BF16)
        assert folded["row"] <= 2.0 ** -6
        assert ok == want, (past, errs)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_decode_plain_f32_out_is_the_unrounded_model(fmt):
    """The decode's plain version with out_dtype f32 (chip_smoke.py's
    witness for decode outputs one bf16 ulp apart) is the same model
    before its last rounding: rounded to bf16 it gives the default call's
    bits, at the kernel's splits and unsplit."""
    gen = torch.Generator().manual_seed(5)
    B, hkv, G, d, ps = 3, 1, 4, 384, 48
    P = 12
    table = torch.randperm(B * P + 2, generator=gen)[:B * P].reshape(
        B, P).to(torch.int32)
    pages = tpf.pack_paged_cache(
        *(torch.randn(hkv, B * P + 2, ps, d, generator=gen).to(BF16)
          for _ in range(2)), fmt)
    q = torch.randn(B, hkv * G, d, generator=gen).to(BF16)
    lengths = torch.tensor([1, ps, P * ps], dtype=torch.int32)
    for splits in ("kernel", None):
        kw = dict(page_size=ps, sm_scale=d ** -0.5, splits=splits)
        out, lse = tpf.fused_paged_decode_plain(q, pages, lengths, table,
                                                **kw)
        model, model_lse = tpf.fused_paged_decode_plain(
            q, pages, lengths, table, out_dtype=torch.float32, **kw)
        assert model.dtype == torch.float32
        assert torch.equal(model.to(BF16), out)
        assert torch.equal(model_lse, lse)
