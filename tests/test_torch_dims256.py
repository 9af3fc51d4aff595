"""Head_dim 256 (and every multiple of 8 in (128, 256]) against the JAX
package, on the CPU.

The JAX package pads any head_dim to whole 128-lane tiles in its forward
and backward, and its dispatch tables hold tiles for 256; its decodes and
append take any width. The port's bf16 flash forward over bf16 K/V and its
bf16 backward read any multiple of 8 up to 256 in place (the wide
instances, 256 columns of tiles), other head dims up to 256 pad to 256 (in
f32 every one: tests/test_torch_dims256_f32.py), and so do the quantized
forward and FA1 (tests/test_torch_dims256_quant_v1.py); the decodes and
the append compile 256 over every
page format (ops/dims.py). Here the
same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernels in interpret mode) and through the port: its public entry
(the plain version at the true head_dim, on the CPU, what the in-place
kernels compute) and, for the flash paths, the padded route (pad to 256,
the plain version, unpad). Gates: fp32 2e-5, bf16 2e-2
(utils/testing.py), the backward at JAX's 1e-5 in f32, the decodes at
bf16's gate (out) and 1e-4 (LSE, f32 q), the append bit for bit. A small
engine at head_dim 256 (4 q heads over 1 kv head, 2 layers) carries JAX's
weights over with params_from_jax and must give JAX's greedy tokens.
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
from tiny_flash_attention_tpu.ops.flash import _xla_attention
from tiny_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from tiny_flash_attention_tpu.ops.paged import (
    paged_decode_attention as jax_paged)
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine as TEngine)
from tiny_flash_attention_tpu_torch.ops import configs, dims
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd, flash_attention_bwd_plain)
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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


# --- the rule ----------------------------------------------------------------


@pytest.mark.parametrize("d", range(129, 521))
def test_in_place_rule_above_128(d):
    """bf16 over bf16 K/V, the forward and the backward take a multiple of
    8 up to 512 in place (the wide instances up to 256, the instances of
    width 512 above), pad any other head_dim in (128, 256] to 256 and in
    (256, 512] to 512, and raise above 512 (queue B-dims-2a-512+); the f32
    forward pads every head_dim in (128, 256] to 256 and in (256, 512] to
    512; the f32 backward and the quantized forward pad (128, 256] to 256
    and raise above, naming themselves and their ROADMAP queues;
    pad_head_dim counts each copy it makes."""
    what, bwd = "the CUDA forward kernel", "the CUDA backward kernels"
    if d > 256:
        with pytest.raises(NotImplementedError, match="int8/e4m3 K/V takes "
                           "head_dim up to 256"):
            dims.flash_head_dim(d, torch.bfloat16, what, quantized=True)
        queue = "B-dims-2a-f32-train" if d <= 512 else "B-dims-2a-512+"
        with pytest.raises(NotImplementedError, match="float32 takes "
                           f"head_dim up to 256.*{queue}"):
            dims.flash_head_dim(d, torch.float32, bwd, backward=True)
        if d <= 512:
            assert dims.flash_head_dim(d, torch.float32, what) == 512
        else:
            with pytest.raises(NotImplementedError, match="float32 takes "
                               "head_dim up to 512.*B-dims-2a-512+"):
                dims.flash_head_dim(d, torch.float32, what)
    else:
        assert dims.flash_head_dim(d, torch.bfloat16, what,
                                   quantized=True) == 256
        assert dims.flash_head_dim(d, torch.float32, what) == 256
        assert dims.flash_head_dim(d, torch.float32, bwd,
                                   backward=True) == 256
        assert dims.kernel_head_dim(d, what, wide=True) == 256
    if d > 512:
        for x in (what, bwd):
            with pytest.raises(NotImplementedError, match="up to 512.*"
                               "B-dims-2a-512+"):
                dims.flash_head_dim(d, torch.bfloat16, x)
        assert not dims.reads_in_place(d)
        return
    in_place = d % 8 == 0
    assert dims.reads_in_place(d) == in_place
    tile = 256 if d <= 256 else 512
    want = d if in_place else tile
    assert dims.flash_head_dim(d, torch.bfloat16, what) == want
    assert dims.flash_width(d, True) == (tile if in_place else 0)
    assert dims.flash_head_dim(d, torch.bfloat16, bwd,
                               backward=True) == want
    x = torch.zeros(1, 1, 3, d)
    before = dims.pad_head_dim.copies
    y = dims.pad_head_dim(x, dims.flash_head_dim(d, torch.bfloat16, what))
    assert y.shape[-1] == want
    assert dims.pad_head_dim.copies == before + (not in_place)


@pytest.mark.parametrize("d", [192, 256])
def test_wide_tiles_and_groups(d):
    """The wide instances' tiles: B1 over 64-row kv tiles in two stages
    (over bf16 K/V and over int8/e4m3 payloads alike), the backward over
    64-row kv blocks; the decode covers a group of 8 at
    head_dim 256 by two row blocks of 4 (its instances stop at G = 4), and
    at 128 by one of 8."""
    from tiny_flash_attention_tpu_torch.ops.flash import fwd_config

    assert fwd_config(torch.bfloat16, False, d) is configs.FLASH_FWD_BF16_WIDE
    assert fwd_config(torch.bfloat16, True, d) is configs.FLASH_FWD_BF16_WIDE
    assert configs.bwd_config(256) is configs.FLASH_BWD_BF16_WIDE
    assert dims.decode_group(8, 256) == (4, 2)
    assert dims.decode_group(3, 256) == (4, 1)
    assert dims.decode_group(12, 256) == (4, 3)
    assert dims.decode_group(2, 256) == (2, 1)
    assert dims.decode_group(8, 128) == (8, 1)
    assert dims.decode_group(12, 128) == (8, 2)


# --- the flash forward and backward ------------------------------------------

FWD_CASES = [(d, group, mask) for d in (192, 256) for group in (1, 8)
             for mask in ("causal", "window", "ids")]


def _ids(b, n, bounds):
    ids = np.zeros((b, n), np.int32)
    for i, x in enumerate(bounds):
        ids[:, x:] = i + 1
    return ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d,group,mask", FWD_CASES)
def test_flash_forward_matches_jax(d, group, mask, dtype):
    """JAX pads head_dim 192 to 256 lanes in its Pallas kernels (q_len 640
    is above its XLA cutoff); the port's entry (at the true head_dim, as
    the wide bf16 kernel reads it in place) and its padded route to 256
    hold to it, out and the LSE."""
    rng = np.random.default_rng(d * 10 + group)
    b, hkv, n = 1, 2 if group == 1 else 1, 640
    q, jq = _both(rng.standard_normal((b, hkv * group, n, d)), dtype)
    k, jk = _both(rng.standard_normal((b, hkv, n, d)), dtype)
    v, jv = _both(rng.standard_normal((b, hkv, n, d)), dtype)
    kw = {}
    if mask == "window":
        kw["window"] = 200
    if mask == "ids":
        ids = _ids(b, n, (100, 333))
        kw["segment_ids"] = (ids, ids)
    jout, jlse = jax_flash(
        jq, jk, jv, causal=True, return_lse=True,
        **{key: (tuple(jnp.asarray(x) for x in val)
                 if key == "segment_ids" else val)
           for key, val in kw.items()})
    tkw = {key: (tuple(torch.from_numpy(x) for x in val)
                 if key == "segment_ids" else val)
           for key, val in kw.items()}
    atol = tolerance_for(dtype)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, **tkw)
    _close(out, jout, atol, "out")
    _close(lse, jlse, atol, "lse")
    pout, plse = flash_attention_plain(
        *(dims.pad_head_dim(t, 256) for t in (q, k, v)), causal=True,
        sm_scale=d ** -0.5, return_lse=True, **tkw)
    _close(dims.unpad_head_dim(pout, d), jout, atol, "padded out")
    _close(plse, jlse, atol, "padded lse")


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("path", ["fused", "split"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_backward_matches_jax(monkeypatch, causal, path, d):
    """JAX's flash_attention_bwd at head_dim 192 (padded to 256) and 256
    (interpret mode); the port's backward (at the true head_dim, as the
    wide bf16 kernels read it in place) and its padded route (q, k, v,
    out, do padded to 256, the plain backward, gradients unpadded) hold
    to it at JAX's 1e-5 in f32."""
    if path == "split":
        monkeypatch.setattr(JFB, "_FUSED_SCRATCH_LIMIT", 0)
    rng = np.random.default_rng(d)
    q_shape, kv_shape = (1, 4, 256, d), (1, 2, 256, d)
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
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    padded = flash_attention_bwd_plain(
        *(dims.pad_head_dim(t, 256) for t in (q, k, v, out)), lse,
        dims.pad_head_dim(do, 256), causal=causal, sm_scale=sc)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, padded, want):
        _close(g, w, 1e-5, name)
        _close(dims.unpad_head_dim(p, d), w, 1e-5, f"padded {name}")
        assert bool((p[..., d:] == 0).all())


@pytest.mark.parametrize("d", [192, 256])
def test_autograd_returns_gradients_at_the_true_head_dim(d):
    """The autograd Function's gradients at head_dim 192 and 256 (group
    8, causal) are those of autograd through the plain forward, at the
    true head_dim."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 8, 100, d), (1, 1, 100, d), (1, 1, 100, d)))
    do = torch.from_numpy(rng.standard_normal((1, 8, 100, d)).astype(
        np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*a, causal=True).backward(do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_plain(*b, causal=True, sm_scale=d ** -0.5).backward(do)
    for x, y in zip(a, b):
        assert x.grad.shape == x.shape
        _close(x.grad, y.grad, 2e-5, "grad")


# --- the decodes and the append ----------------------------------------------

DECODE_CASES = [(group, fmt, window) for group in (1, 2, 8, 12)
                for fmt in ("bf16", "int8") for window in (None, 100)]


def _padded_decode(q, pages, lengths, table, hkv, **kw):
    """The decode as the card runs it at head_dim 256: q rows padded to
    the instance's group (row blocks above it), the kernel's splits,
    unpadded."""
    group = q.shape[1] // hkv
    rows, blocks = dims.decode_group(group, q.shape[-1])
    out, lse = tpf.fused_paged_decode_plain(
        dims.pad_group(q, hkv, rows * blocks), pages, lengths, table,
        splits="kernel", **kw)
    return dims.unpad_group(out, hkv, group), dims.unpad_group(lse, hkv,
                                                                group)


@pytest.mark.parametrize("group,fmt,window", DECODE_CASES)
def test_fused_decode_matches_jax(group, fmt, window):
    """JAX's fused decode at head_dim 256 (interpret mode, its q rows
    padded to 8) at page size 64 over bf16 or int8 pages packed by JAX,
    lengths 1, a page edge, a ragged one and the full table (ring mode:
    past the ring's capacity); the port's entry and its padded route."""
    d = 256
    rng = np.random.default_rng(group + (fmt == "int8"))
    B, hkv, ps, P = 4, 1, 64, 3
    NP = B * P + 2
    q, jq = _both(rng.standard_normal((B, hkv * group, d)), torch.bfloat16)
    kp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    if fmt == "int8":
        jpages = jpf.pack_paged_cache(jnp.asarray(kp), jnp.asarray(vp),
                                      "int8")
        pages = torch.from_numpy(np.array(jpages))
    else:
        kt, jk = _both(kp, torch.bfloat16)
        vt, jv = _both(vp, torch.bfloat16)
        pages = tpf.pack_paged_cache(kt, vt, "bf16")
        jpages = jpf.pack_paged_cache(jk, jv, "bf16")
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, ps, ps + 37, P * ps], np.int32)
    if window is not None:
        lengths = np.array([1, 150, P * ps + 9, 3 * P * ps + 30], np.int32)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps,
        window=window)
    args = (q, pages, torch.from_numpy(lengths), torch.from_numpy(table))
    atol = tolerance_for(torch.bfloat16)
    out, lse = tpf.fused_paged_decode_attention(*args, page_size=ps,
                                                window=window)
    pout, plse = _padded_decode(*args, hkv, page_size=ps,
                                sm_scale=d ** -0.5, window=window)
    for name, (o, l) in (("entry", (out, lse)), ("padded", (pout, plse))):
        _close(o, jout, atol, f"{name} out")
        np.testing.assert_allclose(_np(l), _np(jlse), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [128, 256])
def test_append_matches_jax(ps, fmt):
    """The append at head_dim 256 against the JAX engine's append
    (`_append_rows_scatter`) bit for bit: int8 rows, their amax and
    rounding and the scale bytes (JAX's scale-row layout, 4 * (row / D)),
    at page sizes 128 and 256."""
    d = 256
    rng = np.random.default_rng(ps)
    B, hkv, npages = 3, 1, 6
    prows = tpf.page_rows(ps, d, fmt)
    raw = rng.integers(-5, 5, (hkv, npages, prows, d))
    if fmt == "int8":
        pages = torch.from_numpy(raw.astype(np.int8))
        jpages = jnp.asarray(raw, jnp.int8)
    else:
        pages, jpages = _both(raw, torch.bfloat16)
    k_new, jk = _both(rng.standard_normal((B, hkv, d)) * 3, torch.bfloat16)
    v_new, jv = _both(rng.standard_normal((B, hkv, d)), torch.bfloat16)
    ids = np.array([0, 3, 5], np.int32)
    rows = np.array([0, ps // 2 + 17, ps - 1], np.int32)
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


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_separate_decode_matches_jax(fmt):
    """B12 at head_dim 256, group 8 over one kv head: JAX's
    paged_decode_attention (interpret mode) against the port's entry and
    its padded route."""
    from tiny_flash_attention_tpu.ops import quant as JQ
    from tiny_flash_attention_tpu_torch.ops import quant as TQ

    rng = np.random.default_rng(256)
    B, hkv, group, d, ps, P = 2, 1, 8, 256, 128, 2
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
    lengths = np.array([200, P * ps], np.int32)
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


# --- the engine end to end ---------------------------------------------------


def test_engine_greedy_tokens_match_jax():
    """Two layers at head_dim 256, 4 q heads over 1 kv head (n_q_heads *
    d_head != d_model, as in Gemma-2B), JAX's weights carried over by
    params_from_jax: three prompts through two slots, chunked and
    per-token decode; greedy tokens equal JAX's InferenceEngine's."""
    widths = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
                  n_kv_heads=1, d_head=256, d_ff=256)
    jcfg = JT.ModelConfig(**widths, dtype=jnp.float32, attn_impl="flash")
    tcfg = TT.ModelConfig(**widths, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(256))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(256)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (5, 130, 30)]
    kw = dict(num_pages=16, page_size=64, max_seqs=2, pages_per_seq=6)
    want = JEngine(jcfg, jp, **kw).generate(prompts, max_new_tokens=10,
                                            chunk=4)
    got = TEngine(tcfg, tp, **kw, device="cpu").generate(
        prompts, max_new_tokens=10, chunk=4)
    assert tcfg.group == 4
    assert got == want
