"""The port's quantized serving path against the JAX package's, on the CPU:
int8 fused pages, the int8 decode and the token append (JAX's kernels in
interpret mode), the int8 PagedKVCache, the weight-only quantized model and
the engine with kv_format="int8".

int8 payload bytes must equal those of JAX's quantizer; scale rows are
compared decoded at rtol 1e-6 (XLA may lower amax / 127 one ulp away from
the IEEE quotient, tests/test_paged_fused.py:242-252). Inside `jit` XLA
also reassociates the payload's x / (amax / 127) into x * 127 / amax
(ROADMAP C), so pages that the JAX cache wrote under `jit` may differ from
JAX's own eager quantizer, and from the port, by one int8 level where the
two quotients straddle a rounding boundary: a few elements in 10^5. Those
comparisons hold the port to JAX's eager quantizer byte for byte and to
the jitted pages within that one level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models import inference as JI
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.models.engine import InferenceEngine as JEngine
from tiny_flash_attention_tpu.models.kv_cache import PagedKVCache as JCache
from tiny_flash_attention_tpu.ops import paged_fused as jpf
from tiny_flash_attention_tpu_torch.models import inference as TI
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine as TEngine)
from tiny_flash_attention_tpu_torch.models.kv_cache import (
    PagedKVCache as TCache)
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# the JAX tests' three int8 page geometries at head_dim 128
# (tests/test_paged_fused.py:134-184): ps < d, ps == d, ps == 2d
GEOMETRIES = [64, 128, 256]


def _both(a, dtype=torch.float32):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t, jnp.asarray(t.float().numpy(), _JNP[dtype])


def _assert_int8_pages_equal(got, want, ps, scale_rtol=1e-6):
    """Payload rows byte for byte, scale rows decoded at rtol 1e-6."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got[..., :2 * ps, :], want[..., :2 * ps, :])
    rows, d = got.shape[-2:]
    n = (rows - 2 * ps) // 4 * d      # every f32 of both sides' scale rows
    dec = [tpf._unpack_scale_rows(torch.from_numpy(np.ascontiguousarray(
        x[..., 2 * ps:, :])), n) for x in (got, want)]
    np.testing.assert_allclose(dec[0].numpy(), dec[1].numpy(),
                               rtol=scale_rtol, atol=0)


def _assert_int8_pages_near_jit(got, want, ps, scale_rtol=1e-6):
    """Pages that JAX wrote under jit: scale rows decoded at rtol 1e-6, the
    payload within one int8 level, on at most 1e-4 of the elements."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    diff = np.abs(got[..., :2 * ps, :].astype(np.int32)
                  - want[..., :2 * ps, :].astype(np.int32))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size, (
        diff.max(), np.count_nonzero(diff))
    _assert_int8_pages_equal(np.concatenate(
        [want[..., :2 * ps, :], got[..., 2 * ps:, :]], axis=-2), want, ps,
        scale_rtol)


# --- page format -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("ps", GEOMETRIES)
def test_int8_pages_match_jax(ps, dtype):
    rng = np.random.default_rng(ps)
    kp, jk = _both(rng.standard_normal((2, 3, ps, 128)), dtype)
    vp, jv = _both(rng.standard_normal((2, 3, ps, 128)) * 3, dtype)
    kp[0, 1, 5] = 0.0                 # an all-zero row takes scale 1
    jk = jk.at[0, 1, 5].set(0.0)
    got = tpf.pack_paged_cache(kp, vp, fmt="int8")
    want = jpf.pack_paged_cache(jk, jv, fmt="int8")
    assert tuple(got.shape) == want.shape == (
        2, 3, tpf.page_rows(ps, 128, "int8"), 128)
    _assert_int8_pages_equal(got, want, ps)
    # byte j of token i at [4 * (i // d) + j, i % d] of the scale rows
    sr = tpf.scale_rows_per_side(ps, 128)
    _, _, ks, vs = tpf.unpack_int8_pages(got, ps)
    assert float(ks[0, 1, 5]) == 1.0
    raw = got[0, 0, 2 * ps + sr:].numpy()
    i = ps - 1
    b = bytes(int(raw[4 * (i // 128) + j, i % 128]) & 0xFF for j in range(4))
    assert np.frombuffer(b, np.float32)[0] == float(vs[0, 0, i])


def test_scale_rows_roundtrip_and_bad_geometry():
    for ps, d in [(64, 128), (128, 128), (256, 128), (128, 64)]:
        s = torch.arange(ps, dtype=torch.float32) * 0.37 + 0.01
        packed = tpf._pack_scale_rows(s, d)
        assert tuple(packed.shape) == (tpf.scale_rows_per_side(ps, d), d)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jpf._pack_scale_rows(
                jnp.asarray(s.numpy()), d)))
        torch.testing.assert_close(tpf._unpack_scale_rows(packed, ps), s,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        tpf.scale_rows_per_side(192, 128)


# --- int8 decode -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("ps", GEOMETRIES)
def test_int8_decode_matches_jax_kernel(ps, dtype):
    """The plain int8 decode against `_fused_decode_kernel` in interpret
    mode, over pages packed by JAX: lengths 1, a page edge, a ragged one
    and the full table; group 4."""
    rng = np.random.default_rng(10 + ps)
    B, hkv, hq, d, P = 4, 2, 8, 128, 2
    NP = B * P + 2
    kp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, NP, ps, d)).astype(np.float32)
    jpages = jpf.pack_paged_cache(jnp.asarray(kp), jnp.asarray(vp), "int8")
    pages = torch.from_numpy(np.array(jpages))
    q, jq = _both(rng.standard_normal((B, hq, d)), dtype)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.array([1, ps, ps + 7, P * ps], np.int32)
    out, lse = tpf.fused_paged_decode_attention(
        q, pages, torch.from_numpy(lengths), torch.from_numpy(table),
        page_size=ps)
    jout, jlse = jpf.fused_paged_decode_attention(
        jq, jpages, jnp.asarray(lengths), jnp.asarray(table), page_size=ps)
    assert out.dtype == dtype and out.shape == (B, hq, d)
    atol = tolerance_for(dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=atol,
                               rtol=1e-5)


def test_int8_decode_length_zero_and_clamp():
    """A length-0 row returns zeros and the LSE sentinel (the JAX kernel
    leaves it unwritten, ROADMAP C); a length past the table attends the
    whole table."""
    rng = np.random.default_rng(3)
    ps, d = 64, 128
    pages = tpf.pack_paged_cache(
        torch.from_numpy(rng.standard_normal((1, 4, ps, d)).astype(
            np.float32)),
        torch.from_numpy(rng.standard_normal((1, 4, ps, d)).astype(
            np.float32)), "int8")
    q = torch.from_numpy(rng.standard_normal((3, 2, d)).astype(np.float32))
    table = torch.tensor([[0, 1], [2, 3], [1, 0]], dtype=torch.int32)
    out, lse = tpf.fused_paged_decode_attention(
        q, pages, torch.tensor([0, 1000, 2 * ps], dtype=torch.int32), table,
        page_size=ps)
    assert bool((out[0] == 0).all())
    assert float(lse[0, 0]) < -1e37
    cap, _ = tpf.fused_paged_decode_attention(
        q, pages, torch.tensor([0, 2 * ps, 2 * ps], dtype=torch.int32),
        table, page_size=ps)
    torch.testing.assert_close(out, cap, rtol=0, atol=0)


# --- token append ------------------------------------------------------------


@pytest.mark.parametrize("fmt,ps", [("bf16", 128), ("int8", 64),
                                    ("int8", 128), ("int8", 256)])
def test_append_matches_jax(fmt, ps):
    """The plain append against JAX's `fused_page_append` (interpret mode)
    and `_append_rows_scatter`, into pages of random bytes (mirrors
    tests/test_paged_fused.py:212-252)."""
    rng = np.random.default_rng(ps + (fmt == "int8"))
    B, hkv, npages, d = 3, 2, 8, 128
    prows = tpf.page_rows(ps, d, fmt)
    raw = rng.integers(-5, 5, (hkv, npages, prows, d))
    if fmt == "int8":
        pages = torch.from_numpy(raw.astype(np.int8))
        jpages = jnp.asarray(raw, jnp.int8)
    else:
        pages, jpages = _both(raw, torch.bfloat16)
    k_new, jk = _both(rng.standard_normal((B, hkv, d)))
    v_new, jv = _both(rng.standard_normal((B, hkv, d)))
    ids = np.array([0, 3, 7], np.int32)
    rows = np.array([0, ps // 2, ps - 1], np.int32)
    got = tpf.fused_page_append(pages, k_new, v_new, torch.from_numpy(ids),
                                torch.from_numpy(rows), page_size=ps)
    assert got is pages                       # in place
    wants = [jpf.fused_page_append(jpages, jk, jv, jnp.asarray(ids),
                                   jnp.asarray(rows), page_size=ps),
             JI._append_rows_scatter(jpages, jk, jv, jnp.asarray(ids),
                                     jnp.asarray(rows), page_size=ps,
                                     fmt=fmt)]
    for want in wants:
        if fmt == "bf16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        else:
            _assert_int8_pages_equal(got, want, ps)
    # the engine's dispatch takes the same plain version on the CPU
    again = TI._append_rows(
        torch.from_numpy(raw.astype(np.int8)) if fmt == "int8"
        else _both(raw, torch.bfloat16)[0], k_new, v_new,
        torch.from_numpy(ids), torch.from_numpy(rows), page_size=ps, fmt=fmt)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_append_rejects_a_wrong_format():
    pages = torch.zeros((1, 2, 2 * 16, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 pages"):
        tpf.fused_page_append(pages, torch.zeros((1, 1, 64)),
                              torch.zeros((1, 1, 64)),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), page_size=16)
    with pytest.raises(ValueError, match="format"):
        TI._append_rows(torch.zeros((1, 2, 32, 64)), torch.zeros((1, 1, 64)),
                        torch.zeros((1, 1, 64)),
                        torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), page_size=16,
                        fmt="int8")


# --- the int8 cache ----------------------------------------------------------

GEOM = dict(n_layers=2, n_kv_heads=2, num_pages=12, page_size=64, d_head=128,
            max_seqs=3, pages_per_seq=4)


def test_int8_cache_writes_and_save_load_match_jax(tmp_path):
    """write_prefill, two rounds of append_tokens, then save/load across
    the two packages: the prefill pages equal JAX's eager int8 pack byte for
    byte, the JAX cache's jitted writes within one level, and either
    package reads what the other saved, byte for byte."""
    rng = np.random.default_rng(5)
    nl, hkv, d, ps = 2, 2, 128, 64
    tc = TCache.create(**GEOM, fmt="int8", device="cpu")
    jc = JCache.create(**GEOM, fmt="int8")
    assert tc.pages[0].dtype == torch.int8
    assert tuple(tc.pages[0].shape) == jc.pages[0].shape == (
        hkv, 12, 2 * ps + 8, d)
    for c in (tc, jc):
        c.alloc_slot(130)
        c.alloc_slot(40)
    for slot, L in ((0, 128), (1, 64)):
        k = rng.standard_normal((nl, hkv, L, d)).astype(np.float32)
        v = rng.standard_normal((nl, hkv, L, d)).astype(np.float32)
        tk, jk = _both(k, torch.bfloat16)
        tv, jv = _both(v, torch.bfloat16)
        tc.write_prefill(slot, tk, tv)
        jc.write_prefill(slot, jk, jv)
        tc.lengths[slot] = jc.lengths[slot] = L - 1
        ids = tc.page_table[slot, :L // ps]
        for li in range(nl):
            want = jpf.pack_paged_cache(
                jk[li].reshape(hkv, L // ps, ps, d),
                jv[li].reshape(hkv, L // ps, ps, d), "int8")
            _assert_int8_pages_equal(tc.pages[li][:, ids], want, ps)
    slots = np.array([0, 1])
    for _ in range(2):
        k = rng.standard_normal((nl, hkv, 2, d)).astype(np.float32)
        v = rng.standard_normal((nl, hkv, 2, d)).astype(np.float32)
        tc.append_tokens(slots, torch.from_numpy(k), torch.from_numpy(v))
        jc.append_tokens(slots, jnp.asarray(k), jnp.asarray(v))
    assert tc.lengths.tolist() == jc.lengths.tolist() == [129, 65, 0]
    for tp, jp in zip(tc.pages, jc.pages):
        _assert_int8_pages_near_jit(tp, jp, ps)
    tc.save(str(tmp_path / "t.npz"))
    jc.save(str(tmp_path / "j.npz"))
    for back, src in ((TCache.load(str(tmp_path / "t.npz"), device="cpu"),
                       tc.pages),
                      (TCache.load(str(tmp_path / "j.npz"), device="cpu"),
                       jc.pages)):
        assert back.fmt == "int8" and back.pages[0].dtype == torch.int8
        assert back.page_table.tolist() == tc.page_table.tolist()
        for tp, sp in zip(back.pages, src):
            np.testing.assert_array_equal(tp.numpy(), np.asarray(sp))
    jback = JCache.load(str(tmp_path / "t.npz"))
    assert jback.fmt == "int8"
    for tp, jp in zip(tc.pages, jback.pages):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


# --- model and engine --------------------------------------------------------

SMALL = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)


def _models(dt=jnp.float32, wfmt=None, seed=0):
    tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
    jcfg = JT.ModelConfig(**SMALL, dtype=dt)
    tcfg = TT.ModelConfig(**SMALL, dtype=tdt)
    jp = JT.init_params(jcfg, jax.random.key(seed))
    if wfmt is not None:
        jp = JT.quantize_params(jp, wfmt)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("wfmt", ["int8", "fp8"])
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_quantized_forward_matches_jax(dt, wfmt):
    """Weight-only quantized logits (mirrors tests/test_model.py:91-117):
    f32 at the 2e-5 gate, bf16 at 2e-2 of the largest |logit|."""
    jcfg, jp, tcfg, tp = _models(dt, wfmt)
    toks = np.random.default_rng(1).integers(0, 256, (2, 64)).astype(
        np.int32)
    want = np.asarray(JT.forward(jcfg, jp, jnp.asarray(toks)))
    got = TT.forward(tcfg, tp, torch.from_numpy(toks)).numpy()
    atol = 2e-5 if dt == jnp.float32 else 2e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_int8_decode_step_matches_jax():
    """One decode step over int8 pages written by the same prefill: the
    logits at the f32 gate, the pages within one level of JAX's jitted
    writes."""
    jcfg, jp, tcfg, tp = _models()
    geom = dict(n_layers=2, n_kv_heads=2, num_pages=8, page_size=128,
                d_head=128, max_seqs=2, pages_per_seq=2)
    jc = JCache.create(**geom, fmt="int8", dtype=jnp.float32)
    tc = TCache.create(**geom, fmt="int8", dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    for i, n in enumerate((40, 127)):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :n] = rng.integers(0, 256, n)
        for c in (jc, tc):
            assert c.alloc_slot(2 * 128) == i
        _, jk, jv = JI.prefill_forward(jcfg, jp, jnp.asarray(toks))
        _, tk, tv = TI.prefill_forward(tcfg, tp, torch.from_numpy(toks))
        jc.write_prefill(i, jk, jv)
        tc.write_prefill(i, tk, tv)
        jc.lengths[i] = tc.lengths[i] = n
    tokens = np.array([7, 200], np.int32)
    positions = np.array([40, 127], np.int32)
    jl, jpages = JI.decode_step(
        jcfg, jp, jc.pages, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(jc.page_table), page_size=128, fmt="int8")
    tl, tpages = TI.decode_step(
        tcfg, tp, tc.pages, torch.from_numpy(tokens),
        torch.from_numpy(positions), torch.from_numpy(tc.page_table),
        page_size=128, fmt="int8")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=0)
    for tp_, jp_ in zip(tpages, jpages):
        _assert_int8_pages_near_jit(tp_, jp_, 128)


@pytest.mark.parametrize("wfmt", [None, "int8"], ids=["bf16w", "int8w"])
def test_int8_engine_greedy_tokens_match_jax(wfmt):
    """The engine with kv_format="int8", without and with int8 weights:
    three requests through two slots (admission while another decodes,
    chunked and per-token decode) give JAX's greedy tokens exactly (mirrors
    test_torch_model.py::test_engine_greedy_token_exact_vs_jax)."""
    jcfg, jp, tcfg, tp = _models(wfmt=wfmt)
    jcfg = dataclasses.replace(jcfg, attn_impl="flash")
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (5, 130, 30)]
    kw = dict(num_pages=16, page_size=128, max_seqs=2, pages_per_seq=4,
              kv_format="int8")
    jeng = JEngine(jcfg, jp, **kw)
    teng = TEngine(tcfg, tp, **kw, device="cpu")
    want = jeng.generate(prompts, max_new_tokens=10, chunk=8)
    got = teng.generate(prompts, max_new_tokens=10, chunk=8)
    assert got == want
    assert all(len(g) == 10 for g in got)
    # the K/V rows come out of two f32 models that sum in other orders (with
    # int8 weights, other products too), so their scales agree at the f32
    # gate, 2e-5, rather than to an ulp
    for tpg, jpg in zip(teng.cache.pages, jeng.cache.pages):
        assert tpg.dtype == torch.int8
        _assert_int8_pages_near_jit(tpg, jpg, 128, scale_rtol=2e-5)
