"""The sliding-window model in the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through JAX's functions and the
port's: the windowed forward (JAX's Pallas kernel in interpret mode, the
port's plain version), the ring mode of the fused-page decode over bf16 and
int8 pages with lengths past the table's capacity, the windowed model's
logits, and the windowed engine's greedy tokens against JAX's windowed full
forward, past the ring's capacity too. Gates: fp32 2e-5, bf16 2e-2; greedy
tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.models.kv_cache import PagedKVCache as JCache
from tiny_flash_attention_tpu.ops import paged_fused as jpf
from tiny_flash_attention_tpu.ops.configs import FlashConfig
from tiny_flash_attention_tpu.ops.flash import (
    flash_attention as jax_flash)
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine, Request)
from tiny_flash_attention_tpu_torch.models.kv_cache import (
    PagedKVCache as TCache)
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

INTERP = FlashConfig(block_q=128, block_kv=128, interpret=True)
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SMALL = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --- the windowed forward ----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("q_len,kv_len,window", [
    (1, 512, 128),         # the decode shape
    (128, 384, 100),       # the decode offset, a window off the tiles
    (300, 300, 1),         # window 1: each row sees itself
    (200, 200, 1000),      # a window wider than the sequence: plain causal
])
def test_window_forward_matches_jax(dtype, q_len, kv_len, window):
    arrs = _arrays(0, (1, 4, q_len, 64), (1, 2, kv_len, 64),
                   (1, 2, kv_len, 64))
    t = [torch.from_numpy(a).to(dtype) for a in arrs]
    j = [jnp.asarray(a, _JNP[dtype]) for a in arrs]
    out, lse = flash_attention(*t, causal=True, window=window,
                               return_lse=True)
    jout, jlse = jax_flash(*j, causal=True, window=window, config=INTERP,
                           return_lse=True)
    atol = tolerance_for(dtype)
    np.testing.assert_allclose(_np(out), _np(jout), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=atol, rtol=1e-5)
    if window >= kv_len:
        plain = flash_attention(*t, causal=True, return_lse=True)
        assert all(torch.equal(a, b) for a, b in zip((out, lse), plain))
    row, _ = flash_attention_rowloop(*t, causal=True, window=window)
    assert torch.equal(row, out)


def test_window_with_segments_matches_jax():
    """Window and packed segments compose (tests/test_window.py:79-108),
    and segment_starts change nothing on the CPU."""
    L1, L2, w = 150, 106, 80
    arrs = _arrays(1, (1, 4, L1 + L2, 64), (1, 2, L1 + L2, 64),
                   (1, 2, L1 + L2, 64))
    seg = np.asarray([[1] * L1 + [2] * L2], np.int32)
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    out = flash_attention(*(torch.from_numpy(a) for a in arrs), causal=True,
                          window=w, segment_ids=(tseg, tseg),
                          segment_starts=(0, L1))
    jout = jax_flash(*(jnp.asarray(a) for a in arrs), causal=True,
                     window=w, segment_ids=(jseg, jseg), config=INTERP)
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-5, rtol=0)


# --- the ring mode of the fused-page decode ----------------------------------


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_ring_decode_matches_jax(fmt):
    """Lengths inside the table and past it (a ring that wrapped once and
    more than once), a window band that straddles a page boundary, and a
    window wider than the length."""
    B, hkv, hq, d, ps, P, NP = 4, 2, 8, 64, 16, 6, 30
    window = 40
    q, kp, vp = _arrays(2, (B, hq, d), (hkv, NP, ps, d), (hkv, NP, ps, d))
    table = np.random.default_rng(3).permutation(NP)[:B * P].reshape(B, P)
    table = table.astype(np.int32)
    lengths = np.asarray([25, 90, 97 + 2 * P * ps, 200], np.int32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tpages = tpf.pack_paged_cache(torch.from_numpy(kp).to(torch.bfloat16),
                                  torch.from_numpy(vp).to(torch.bfloat16),
                                  fmt)
    jpages = jnp.asarray(tpages.view(torch.int16).numpy()).view(
        jnp.bfloat16) if fmt == "bf16" else jnp.asarray(tpages.numpy())
    out, lse = tpf.fused_paged_decode_attention(
        tq, tpages, torch.from_numpy(lengths), torch.from_numpy(table),
        page_size=ps, window=window)
    jout, jlse = jpf.fused_paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jpages, jnp.asarray(lengths),
        jnp.asarray(table), page_size=ps, window=window, interpret=True)
    atol = tolerance_for(torch.bfloat16)
    np.testing.assert_allclose(_np(out), _np(jout), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=atol, rtol=1e-5)


def test_ring_decode_is_the_window_of_the_unwrapped_cache():
    """Below the capacity the ring mode equals the windowed attention over
    the same tokens laid out without wrapping: the last `window` tokens."""
    B, hkv, hq, d, ps, P = 2, 2, 4, 64, 16, 8
    q, kp, vp = _arrays(4, (B, hq, d), (hkv, B * P, ps, d),
                        (hkv, B * P, ps, d))
    pages = tpf.pack_paged_cache(torch.from_numpy(kp), torch.from_numpy(vp))
    table = torch.arange(B * P, dtype=torch.int32).reshape(B, P)
    lengths = torch.tensor([70, 128], dtype=torch.int32)
    out, _ = tpf.fused_paged_decode_attention(
        torch.from_numpy(q), pages, lengths, table, page_size=ps, window=33)
    k = torch.from_numpy(kp).reshape(hkv, B, P * ps, d).transpose(0, 1)
    v = torch.from_numpy(vp).reshape(hkv, B, P * ps, d).transpose(0, 1)
    for b, n in enumerate(lengths.tolist()):
        want = flash_attention(torch.from_numpy(q)[b:b + 1, :, None],
                               k[b:b + 1, :, :n], v[b:b + 1, :, :n],
                               causal=True, window=33)
        torch.testing.assert_close(out[b], want[0, :, 0], atol=2e-5,
                                   rtol=0)


def test_ring_decode_rejects_a_window_past_the_capacity():
    q = torch.zeros((1, 2, 64))
    pages = torch.zeros((1, 4, 32, 64))
    for window in (0, 2 * 16 + 1):
        with pytest.raises(ValueError, match="window"):
            tpf.fused_paged_decode_attention(
                q, pages, torch.ones(1, dtype=torch.int32),
                torch.zeros((1, 2), dtype=torch.int32), page_size=16,
                window=window)


# --- the ring cache's writes -------------------------------------------------


def test_append_wraps_the_ring_like_jax():
    """A slot past its table's capacity writes onto logical page (pos //
    ps) % P, in the port's cache as in JAX's."""
    geom = dict(n_layers=1, n_kv_heads=2, num_pages=6, page_size=16,
                d_head=64, max_seqs=2, pages_per_seq=2)
    tc = TCache.create(**geom, dtype=torch.float32, device="cpu")
    jc = JCache.create(**geom, dtype=jnp.float32)
    k, v = _arrays(5, (1, 2, 2, 64), (1, 2, 2, 64))
    for c in (tc, jc):
        for _ in range(2):
            c.alloc_slot(32)
        c.lengths[:] = [40, 77]             # both rings wrapped
    tc.append_tokens(np.arange(2), torch.from_numpy(k), torch.from_numpy(v))
    jc.append_tokens(np.arange(2), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(tc.pages[0].numpy(), np.asarray(jc.pages[0]))
    assert tc.lengths.tolist() == jc.lengths.tolist() == [41, 78]
    page = tc.page_table[0, (40 // 16) % 2]
    torch.testing.assert_close(tc.pages[0][:, page, 40 % 16],
                               torch.from_numpy(k[0, :, 0]))


def test_free_slot_returns_what_was_allocated():
    """After a wrap the length says nothing of the pages held: freeing
    returns the allocation, as JAX's cache does."""
    geom = dict(n_layers=1, n_kv_heads=1, num_pages=9, page_size=16,
                d_head=64, max_seqs=2, pages_per_seq=4)
    tc = TCache.create(**geom, dtype=torch.float32, device="cpu")
    jc = JCache.create(**geom, dtype=jnp.float32)
    for c in (tc, jc):
        before = sorted(c.free_pages)
        slot = c.alloc_slot(64)
        c.lengths[slot] = 1000                # wrapped many times
        c.free_slot(slot)
        assert sorted(c.free_pages) == before
        assert c.alloc_counts.tolist() == [0, 0]


# --- the windowed model and engine -------------------------------------------


def _models(window, seed=0):
    jcfg = JT.ModelConfig(**SMALL, dtype=jnp.float32, attn_impl="flash",
                          attn_window=window)
    tcfg = TT.ModelConfig(**SMALL, dtype=torch.float32, attn_window=window)
    jp = JT.init_params(jcfg, jax.random.key(seed))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _jax_greedy(jcfg, jp, seq):
    """JAX's windowed full forward over a sequence: the argmax at each
    position (causal + window attention is incremental)."""
    logits = JT.forward(jcfg, jp, jnp.asarray([seq], jnp.int32))
    return np.asarray(jnp.argmax(logits[0], axis=-1)).tolist()


def test_windowed_logits_match_jax():
    jcfg, jp, tcfg, tp = _models(48)
    toks = np.random.default_rng(6).integers(0, 256, (2, 200)).astype(
        np.int32)
    want = JT.forward(jcfg, jp, jnp.asarray(toks))
    got = TT.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="flash"):
        TT.forward(dataclasses.replace(tcfg, attn_impl="reference"), tp,
                   torch.from_numpy(toks))


def test_windowed_engine_matches_jax_full_forward():
    """tests/test_model.py:218-236 on the port: greedy decode through the
    windowed prefill and the ring decode reproduces JAX's windowed full
    forward token by token."""
    jcfg, jp, tcfg, tp = _models(96)
    prompt = list(map(int, np.random.default_rng(9).integers(0, 256, 150)))
    eng = InferenceEngine(tcfg, tp, num_pages=64, page_size=128, max_seqs=2,
                          pages_per_seq=4, device="cpu")
    out = eng.generate([prompt], max_new_tokens=8)[0]
    want = _jax_greedy(jcfg, jp, prompt + out)[len(prompt) - 1:-1]
    assert out == want


def test_ring_cache_runs_past_its_capacity():
    """tests/test_model.py:239-262 on the port: with a window the cache is a
    ring, and generation past the table's capacity (64 tokens, wrapped
    almost twice) still matches JAX's windowed full forward; the slot is
    freed at the end."""
    jcfg, jp, tcfg, tp = _models(32)
    prompt = list(map(int, np.random.default_rng(13).integers(0, 256, 20)))
    eng = InferenceEngine(tcfg, tp, num_pages=16, page_size=16, max_seqs=2,
                          pages_per_seq=4, device="cpu")
    before = len(eng.cache.free_pages)
    out = eng.generate([prompt], max_new_tokens=100, chunk=32)[0]
    assert len(out) == 100 and len(prompt) + len(out) > 4 * 16
    want = _jax_greedy(jcfg, jp, prompt + out)[len(prompt) - 1:-1]
    div = next((t for t in range(100) if out[t] != want[t]), None)
    assert div is None, f"diverged at step {div}"
    assert int(eng.cache.lengths.max()) == 0
    assert len(eng.cache.free_pages) == before


def test_windowed_slots_free_all_pages():
    """tests/test_model.py:265-275 on the port: a ring slot holds the full
    table width, and freeing returns all of it."""
    _, _, tcfg, tp = _models(96)
    eng = InferenceEngine(tcfg, tp, num_pages=64, page_size=128, max_seqs=2,
                          pages_per_seq=4, device="cpu")
    before = len(eng.cache.free_pages)
    for round_ in range(8):
        eng.add_request(Request([1, 2, 3], 2))
        assert len(eng.cache.free_pages) == before - 4
        eng.steps(1)
        eng.collect_finished()
        assert len(eng.cache.free_pages) == before, round_


def test_ring_cache_refuses_what_it_cannot_hold():
    _, _, tcfg, tp = _models(96)
    kw = dict(num_pages=16, page_size=64, max_seqs=2, device="cpu")
    with pytest.raises(ValueError, match="ring capacity"):
        InferenceEngine(tcfg, tp, pages_per_seq=3, **kw).add_requests(
            [Request([1, 2, 3], 4)])          # 192 < 96 + 2 * 64
    eng = InferenceEngine(tcfg, tp, pages_per_seq=4, **kw)
    with pytest.raises(ValueError, match="exceeds the ring"):
        eng.add_requests([Request(list(range(257)), 4)])
    for admit in (eng.add_requests_packed, eng.add_requests_jagged):
        with pytest.raises(ValueError, match="windowed ring"):
            admit([Request([1, 2, 3], 4)])
