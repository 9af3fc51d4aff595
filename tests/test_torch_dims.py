"""Head dims and GQA groups that no kernel instance compiles, against the JAX
package, on the CPU.

The JAX package takes any head_dim (its forward and backward pad it to 128
lanes) and any group (its decodes pad a kv head's q rows to 8). The port's
bf16 flash forward and backward read any head_dim that is a multiple of 8
in place (up to 256: tests/test_torch_dims256.py holds the wide instances);
its f32 and quantized flash instances and FA1 take tiles of 64/128
columns, the decodes and append head_dim 64/80/96/128 (and 256), and the
decodes groups 1/2/4/8; its wrappers pad around them with ops/dims.py
(`flash_head_dim` is the rule). Here the same numpy inputs, made from a
seed, go through the JAX function (its Pallas kernels in interpret mode,
or its XLA route where JAX takes one) and through the port twice: its
public entry (the plain version at the true head_dim, on the CPU, what
the in-place kernels compute) and the padded route (pad, the plain
version in the kernel's place, unpad). Gates: fp32 2e-5, bf16 2e-2
(utils/testing.py);
the append and the int8 pages bit for bit. Two small engines (2 layers,
head_dim 96 at group 1, head_dim 128 at group 3) carry JAX's weights over
with params_from_jax and must give JAX's greedy tokens.
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
from tiny_flash_attention_tpu_torch.ops import dims
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


# --- the helpers -------------------------------------------------------------


@pytest.mark.parametrize("d,dk", [(1, 64), (48, 64), (64, 64), (72, 128),
                                  (80, 128), (96, 128), (128, 128),
                                  (130, 256), (200, 256), (256, 256)])
def test_kernel_head_dim_pads_to_the_next_instance(d, dk):
    assert dims.kernel_head_dim(d, "the kernel", wide=dk > 128) == dk
    x = torch.randn(2, 3, 5, d)
    padded = dims.pad_head_dim(x, dk)
    if d == dk:
        assert padded is x                    # no copy at an instance
        assert dims.unpad_head_dim(x, d) is x
    else:
        assert padded.shape == (2, 3, 5, dk)
        assert bool((padded[..., d:] == 0).all())
    assert torch.equal(dims.unpad_head_dim(padded, d), x)


@pytest.mark.parametrize("d", range(1, 137))
def test_in_place_rule(d):
    """bf16 over bf16 K/V, the flash kernels take a head_dim that is a
    multiple of 8 in place (64, 128 and 256 are their tiles' own widths)
    and pad any other to the next tile width (256 above 128: the wide
    instances, tests/test_torch_dims256.py); pad_head_dim counts each copy
    it makes."""
    what = "the CUDA forward kernel"
    in_place = d % 8 == 0
    assert dims.reads_in_place(d) == in_place
    want = d if in_place else dims.kernel_head_dim(d, what, wide=True)
    assert dims.flash_head_dim(d, torch.bfloat16, what) == want
    x = torch.zeros(1, 1, 3, d)
    before = dims.pad_head_dim.copies
    y = dims.pad_head_dim(x, dims.flash_head_dim(d, torch.bfloat16, what))
    assert y.shape[-1] == want
    assert dims.pad_head_dim.copies == before + (not in_place)


@pytest.mark.parametrize("d", [8, 48, 72, 80, 96, 100])
def test_f32_and_quantized_entries_pad(d):
    """The f32 instances and the quantized forward read tiles of 64 or 128
    columns: every head_dim pads to the next (what the card's wrappers do
    before launching them)."""
    what = "the CUDA forward kernel"
    dk = dims.kernel_head_dim(d, what)
    assert dims.flash_head_dim(d, torch.float32, what) == dk
    assert dims.flash_head_dim(d, torch.bfloat16, what,
                               quantized=True) == dk
    assert dk in dims.FLASH_HEAD_DIMS and dk > d


def test_head_dims_above_128_raise():
    """Above 256 the bf16 forward over bf16 K/V and the bf16 backward take
    every head_dim up to 512 (a multiple of 8 in place, any other padded to
    512), and so does the f32 forward (padded to 512); the f32 backward,
    the quantized forward and FA1 raise there, each naming itself and its
    ROADMAP queue (the f32 backward B-dims-2a-f32-train), and each pads
    (128, 256] to 256; the decodes (q in bf16 and f32) and the append take
    every head_dim up to 512 (72, 112, 192, 300 and 384 among them); above
    512 everything raises, naming queue B-dims-2a-512+."""
    fwd, bwd = "the CUDA forward kernel", "the CUDA backward kernels"
    for d in (264, 384, 512):
        with pytest.raises(NotImplementedError, match="up to 256.*"
                           "B-dims-2a-quant-v1"):
            dims.kernel_head_dim(d, fwd, wide=True)
        assert dims.flash_head_dim(d, torch.bfloat16, fwd) == d
        assert dims.flash_head_dim(d, torch.bfloat16, bwd,
                                   backward=True) == d
        assert dims.flash_head_dim(d, torch.float32, fwd) == 512
        with pytest.raises(NotImplementedError, match="float32 takes "
                           "head_dim up to 256.*B-dims-2a-f32-train"):
            dims.flash_head_dim(d, torch.float32, bwd, backward=True)
    for d in (264, 384):
        with pytest.raises(NotImplementedError, match="FA1 kernel takes "
                           "head_dim up to 256.*B-dims-2a-quant-v1"):
            dims.kernel_head_dim(d, "the CUDA FA1 kernel", wide=True)
        with pytest.raises(NotImplementedError, match="K/V takes head_dim "
                           "up to 256.*B-dims-2a-quant-v1"):
            dims.flash_head_dim(d, torch.bfloat16, fwd, quantized=True)
    for d in (129, 192, 256):
        assert dims.flash_head_dim(d, torch.float32, fwd) == 256
        assert dims.flash_head_dim(d, torch.float32, bwd,
                                   backward=True) == 256
        assert dims.kernel_head_dim(d, "the CUDA FA1 kernel",
                                    wide=True) == 256
        assert dims.flash_head_dim(d, torch.bfloat16, fwd,
                                   quantized=True) == 256
    for d in (520, 576):
        for call in (
                lambda: dims.flash_head_dim(d, torch.bfloat16, fwd),
                lambda: dims.flash_head_dim(d, torch.bfloat16, bwd),
                lambda: dims.flash_head_dim(d, torch.float32, fwd),
                lambda: dims.flash_head_dim(d, torch.float32, bwd,
                                            backward=True),
                lambda: dims.flash_head_dim(d, torch.bfloat16, fwd,
                                            quantized=True),
                lambda: dims.decode_q_head_dim(d, torch.float32),
                lambda: dims.kernel_head_dim(d, "the CUDA FA1 kernel",
                                             wide=True),
                lambda: dims.decode_head_dim(d, "the CUDA decode kernel"),
                lambda: dims.decode_head_dim(d, "the CUDA append kernel")):
            with pytest.raises(NotImplementedError, match="B-dims-2a-512+"):
                call()
    for d in (264, 384, 512):
        dims.decode_q_head_dim(d, torch.bfloat16)
        dims.decode_q_head_dim(d, torch.float32)
    for d in (*dims.DECODE_HEAD_DIMS, 72, 112, 192, 300, 384):
        dims.decode_head_dim(d, "the CUDA decode kernel")
        dims.decode_head_dim(d, "the CUDA append kernel")


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn],
                         ids=str)
def test_payloads_pad_with_exact_zeros(dtype):
    """int8 and e4m3 payloads pad with code 0, an exact zero in both."""
    x = (torch.randn(2, 2, 7, 96) * 4).to(dtype)
    padded = dims.pad_head_dim(x, 128)
    assert padded.dtype == dtype
    assert bool((padded[..., 96:].view(torch.uint8) == 0).all())
    assert bool((padded[..., 96:].float() == 0).all())
    assert torch.equal(padded[..., :96].view(torch.uint8),
                       x.view(torch.uint8))


@pytest.mark.parametrize("group,rows,blocks", [
    (1, 1, 1), (2, 2, 1), (3, 4, 1), (4, 4, 1), (5, 8, 1), (6, 8, 1),
    (7, 8, 1), (8, 8, 1), (9, 8, 2), (12, 8, 2), (16, 8, 2), (24, 8, 3)])
def test_decode_group_covers_the_group(group, rows, blocks):
    assert dims.decode_group(group) == (rows, blocks)
    q = torch.randn(3, 2 * group, 5)
    padded = dims.pad_group(q, 2, rows * blocks)
    assert padded.shape == (3, 2 * rows * blocks, 5)
    if rows * blocks == group:
        assert padded is q
    view = padded.reshape(3, 2, rows * blocks, 5)
    assert bool((view[:, :, group:] == 0).all())
    assert torch.equal(dims.unpad_group(padded, 2, group), q)


@pytest.mark.parametrize("d,group", [(72, 3), (80, 7), (96, 1), (96, 3)])
def test_padded_forward_equals_plain(d, group):
    """pad, the plain forward, unpad equals the plain forward at the true
    head_dim, at 2e-5 in f32 (the scale from the true head_dim)."""
    rng = np.random.default_rng(d + group)
    q = torch.from_numpy(rng.standard_normal((2, 2 * group, 70, d))).float()
    k = torch.from_numpy(rng.standard_normal((2, 2, 90, d))).float()
    v = torch.from_numpy(rng.standard_normal((2, 2, 90, d))).float()
    sc = d ** -0.5
    want = flash_attention_plain(q, k, v, causal=True, sm_scale=sc,
                                 return_lse=True)
    dk = dims.kernel_head_dim(d, "the kernel")
    out, lse = flash_attention_plain(
        *(dims.pad_head_dim(t, dk) for t in (q, k, v)), causal=True,
        sm_scale=sc, return_lse=True)
    _close(dims.unpad_head_dim(out, d), want[0], 2e-5, "out")
    _close(lse, want[1], 2e-5, "lse")
    assert bool((out[..., d:] == 0).all())


@pytest.mark.parametrize("group", [3, 5, 12, 16])
def test_padded_decode_equals_plain(group):
    """pad a kv head's q rows, the plain decode, unpad equals the plain
    decode at the true group, at 2e-5 in f32."""
    rng = np.random.default_rng(group)
    B, hkv, d, ps, P = 3, 2, 96, 16, 4
    NP = B * P + 2
    q = torch.from_numpy(rng.standard_normal((B, hkv * group, d))).float()
    pages = torch.from_numpy(
        rng.standard_normal((hkv, NP, 2 * ps, d))).float()
    table = torch.from_numpy(
        rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32))
    lengths = torch.tensor([1, ps + 3, P * ps], dtype=torch.int32)
    kw = dict(page_size=ps, sm_scale=d ** -0.5)
    want = tpf.fused_paged_decode_plain(q, pages, lengths, table, **kw)
    got = _padded_decode(q, pages, lengths, table, hkv, **kw)
    for g, w, name in zip(got, want, ("out", "lse")):
        _close(g, w, 2e-5, name)


def _padded_decode(q, pages, lengths, table, hkv, **kw):
    """The decode as the card runs it: q rows padded to the instance's
    group (row blocks above 8), the kernel's splits, unpadded."""
    group = q.shape[1] // hkv
    rows, blocks = dims.decode_group(group)
    out, lse = tpf.fused_paged_decode_plain(
        dims.pad_group(q, hkv, rows * blocks), pages, lengths, table,
        splits="kernel", **kw)
    return dims.unpad_group(out, hkv, group), dims.unpad_group(lse, hkv,
                                                                group)


# --- the flash forward and backward ------------------------------------------

FWD_CASES = [(d, group, mask) for d in (48, 72, 80, 96) for group in (3, 7)
             for mask in ("causal", "window", "ids")]


def _ids(b, n, bounds):
    ids = np.zeros((b, n), np.int32)
    for i, x in enumerate(bounds):
        ids[:, x:] = i + 1
    return ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d,group,mask", FWD_CASES)
def test_flash_forward_matches_jax(d, group, mask, dtype):
    """JAX pads head_dim to 128 lanes in its Pallas kernels (q_len 640 is
    above its XLA cutoff); the port's entry (at the true head_dim, as the
    bf16 kernels read it in place) and its padded route hold to it, out
    and the LSE."""
    rng = np.random.default_rng(d * 10 + group)
    b, hkv, n = 1, 2, 640
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
    dk = dims.kernel_head_dim(d, "the kernel")
    pout, plse = flash_attention_plain(
        *(dims.pad_head_dim(t, dk) for t in (q, k, v)), causal=True,
        sm_scale=d ** -0.5, return_lse=True, **tkw)
    _close(dims.unpad_head_dim(pout, d), jout, atol, "padded out")
    _close(plse, jlse, atol, "padded lse")


@pytest.mark.parametrize("d", [48, 80, 96])
@pytest.mark.parametrize("path", ["fused", "split"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_backward_matches_jax(monkeypatch, causal, path, d):
    """JAX's flash_attention_bwd pads head_dim 48, 80 and 96 to 128
    (interpret mode); the port's backward (at the true head_dim, as the
    bf16 kernels read it in place) and its padded route (q, k, v, out, do
    padded, the plain backward, gradients unpadded) hold to it at JAX's
    1e-5 in f32."""
    if path == "split":
        monkeypatch.setattr(JFB, "_FUSED_SCRATCH_LIMIT", 0)
    rng = np.random.default_rng(d)
    q_shape, kv_shape = (1, 6, 256, d), (1, 2, 256, d)
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
    dk = dims.kernel_head_dim(d, "the kernel")
    padded = flash_attention_bwd_plain(
        *(dims.pad_head_dim(t, dk) for t in (q, k, v, out)), lse,
        dims.pad_head_dim(do, dk), causal=causal, sm_scale=sc)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, padded, want):
        _close(g, w, 1e-5, name)
        _close(dims.unpad_head_dim(p, d), w, 1e-5, f"padded {name}")
        assert bool((p[..., d:] == 0).all())


@pytest.mark.parametrize("d", [48, 80, 96])
def test_autograd_returns_gradients_at_the_true_head_dim(d):
    """The autograd Function's gradients at head_dim 48, 80 and 96 are
    those of autograd through the plain forward, at the true head_dim."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 6, 100, d), (1, 2, 100, d), (1, 2, 100, d)))
    do = torch.from_numpy(rng.standard_normal((1, 6, 100, d)).astype(
        np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*a, causal=True).backward(do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_plain(*b, causal=True, sm_scale=d ** -0.5).backward(do)
    for x, y in zip(a, b):
        assert x.grad.shape == x.shape
        _close(x.grad, y.grad, 2e-5, "grad")


# --- the decodes and the append ----------------------------------------------

DECODE_CASES = [(d, group, fmt, window) for d in (80, 96)
                for group in (3, 5, 12, 16) for fmt in ("bf16", "int8")
                for window in (None, 100)]


@pytest.mark.parametrize("d,group,fmt,window", DECODE_CASES)
def test_fused_decode_matches_jax(d, group, fmt, window):
    """JAX's fused decode (interpret mode, its q rows padded to 8) at page
    size 64 over bf16 or int8 pages packed by JAX, lengths 1, a page edge,
    a ragged one and the full table (ring mode: past the ring's capacity);
    the port's entry and its padded route (`_padded_decode`)."""
    rng = np.random.default_rng(d + group + (fmt == "int8"))
    B, hkv, ps, P = 4, 2, 64, 3
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
@pytest.mark.parametrize("d,ps", [(80, 64), (96, 64), (80, 160)])
def test_append_matches_jax(d, ps, fmt):
    """The append at head_dim 80 and 96 against the JAX engine's append
    (`_append_rows_scatter`) bit for bit: int8 rows, their amax and
    rounding and the scale bytes (160 tokens at head_dim 80: two scale
    groups a page). JAX's `fused_page_append` kernel in interpret mode
    rounds its scale otherwise on a few rows (its payload one int8 level
    off on those, as JAX's jitted quantizer, SKILL.md): against it the
    payload within one level on at most 1e-4 of the bytes, the scales at
    rtol 1e-6."""
    rng = np.random.default_rng(d + ps)
    B, hkv, npages = 3, 2, 8
    prows = tpf.page_rows(ps, d, fmt)
    raw = rng.integers(-5, 5, (hkv, npages, prows, d))
    if fmt == "int8":
        pages = torch.from_numpy(raw.astype(np.int8))
        jpages = jnp.asarray(raw, jnp.int8)
    else:
        pages, jpages = _both(raw, torch.bfloat16)
    k_new, jk = _both(rng.standard_normal((B, hkv, d)) * 3, torch.bfloat16)
    v_new, jv = _both(rng.standard_normal((B, hkv, d)), torch.bfloat16)
    ids = np.array([0, 3, 7], np.int32)
    rows = np.array([0, ps // 2 + 17, ps - 1], np.int32)
    got = tpf.fused_page_append(pages, k_new, v_new, torch.from_numpy(ids),
                                torch.from_numpy(rows), page_size=ps)
    scatter = np.asarray(JI._append_rows_scatter(
        jpages, jk, jv, jnp.asarray(ids), jnp.asarray(rows), page_size=ps,
        fmt=fmt))
    kernel = np.asarray(jpf.fused_page_append(
        jpages, jk, jv, jnp.asarray(ids), jnp.asarray(rows), page_size=ps))
    if fmt == "bf16":
        for want in (scatter, kernel):
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        return
    got = got.numpy()
    np.testing.assert_array_equal(got, scatter)
    diff = np.abs(got[..., :2 * ps, :].astype(np.int32)
                  - kernel[..., :2 * ps, :].astype(np.int32))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size
    n = (prows - 2 * ps) // 4 * d
    dec = [tpf._unpack_scale_rows(torch.from_numpy(np.ascontiguousarray(
        x[..., 2 * ps:, :])), n) for x in (got, kernel)]
    np.testing.assert_allclose(dec[0].numpy(), dec[1].numpy(), rtol=1e-6,
                               atol=0)


def test_int8_page_rule_follows_jax():
    """JAX's int8 page rule: page_size <= head_dim or a multiple of it; at
    head_dim 96 page size 64 packs and 128 does not, in both packages."""
    for ps, d in ((64, 96), (96, 96), (192, 96), (64, 80), (160, 80)):
        assert tpf.scale_rows_per_side(ps, d) == \
            jpf.scale_rows_per_side(ps, d)
    for ps, d in ((128, 96), (128, 80)):
        with pytest.raises(ValueError):
            tpf.scale_rows_per_side(ps, d)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_separate_decode_matches_jax(fmt):
    """B12 at head_dim 96, group 3: JAX's paged_decode_attention (interpret
    mode) against the port's entry and its padded route."""
    from tiny_flash_attention_tpu.ops import quant as JQ
    from tiny_flash_attention_tpu_torch.ops import quant as TQ

    rng = np.random.default_rng(3)
    B, hkv, group, d, ps, P = 2, 2, 3, 96, 128, 2
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
    rows, blocks = dims.decode_group(group)
    pout, plse = paged_decode_plain(dims.pad_group(q, hkv, rows * blocks),
                                    k, v, tl, tt, sm_scale=d ** -0.5,
                                    splits="kernel")
    for o, l in ((out, lse), (dims.unpad_group(pout, hkv, group),
                              dims.unpad_group(plse, hkv, group))):
        _close(o, jout, 1e-4, "out")
        _close(l, jlse, 1e-4, "lse")


# --- the engine end to end ---------------------------------------------------


@pytest.mark.parametrize("d_head,n_q,n_kv,ps", [
    (96, 4, 4, 64), (128, 6, 2, 64), (100, 4, 4, 48), (36, 6, 2, 8)],
    ids=["d96-group1", "d128-group3", "d100-group1-ps48",
         "d36-group3-ps8"])
def test_engine_greedy_tokens_match_jax(d_head, n_q, n_kv, ps):
    """Two layers at small widths, JAX's weights carried over by
    params_from_jax: three prompts through two slots, chunked and
    per-token decode; greedy tokens equal JAX's InferenceEngine's (head
    dims 100 and 36 at page sizes 48 and 8: the run-time width
    instances' shapes)."""
    widths = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=n_q,
                  n_kv_heads=n_kv, d_head=d_head, d_ff=256)
    jcfg = JT.ModelConfig(**widths, dtype=jnp.float32, attn_impl="flash")
    tcfg = TT.ModelConfig(**widths, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(d_head))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(d_head)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (5, 130, 30)]
    kw = dict(num_pages=16 * 64 // ps, page_size=ps, max_seqs=2,
              pages_per_seq=6 * 64 // ps)
    want = JEngine(jcfg, jp, **kw).generate(prompts, max_new_tokens=10,
                                            chunk=4)
    got = TEngine(tcfg, tp, **kw, device="cpu").generate(
        prompts, max_new_tokens=10, chunk=4)
    assert tcfg.group == n_q // n_kv
    assert got == want
