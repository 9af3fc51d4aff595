"""Ragged admission on the CPU: the port's packed and jagged prefill and
the engine's add_requests_packed / add_requests_jagged against the JAX
package's, with the JAX weights carried over by params_from_jax. The JAX
side runs its Pallas kernels (the work-list kernel with segment_starts, the
row-loop kernel with seq_lengths) in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models import inference as JI
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.models.engine import (
    InferenceEngine as JEngine, Request as JRequest)
from tiny_flash_attention_tpu_torch.models import inference as TI
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine as TEngine, Request, pack_prompts, pad_prompts)

SMALL = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
PS = 128


@functools.lru_cache(maxsize=None)
def _models(dt="f32"):
    jdt, tdt = _DT[dt]
    jcfg = JT.ModelConfig(**SMALL, dtype=jdt)
    tcfg = TT.ModelConfig(**SMALL, dtype=tdt)
    jp = JT.init_params(jcfg, jax.random.key(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, 256, n))) for n in lengths]


def _tol(dt, want):
    """fp32: the 2e-5 gate; bf16: 2e-2 of the largest magnitude."""
    if dt == "f32":
        return 2e-5
    return 2e-2 * float(np.max(np.abs(want)))


def _close(got, want, dt, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.max(np.abs(got - want)))
    assert err <= _tol(dt, want), f"{name}: max abs err {err:.3e}"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bucket", ["page", "pow2"])
def test_prefill_packed_matches_jax(dt, bucket):
    """896 (page) or 1152 (pow2) packed tokens: JAX takes its work-list
    kernel pruned by segment_starts. Logits and K/V are compared on every
    prompt's own rows."""
    jcfg, jp, tcfg, tp = _models(dt)
    prompts = _prompts((300, 130, 200), 1)
    toks, segs, pos, offs = pack_prompts(prompts, PS, bucket)
    jl, jk, jv = JI.prefill_forward_packed(
        jcfg, jp, jnp.asarray(toks), jnp.asarray(segs), jnp.asarray(pos),
        segment_starts=tuple(offs))
    tl, tk, tv = TI.prefill_forward_packed(
        tcfg, tp, torch.from_numpy(toks), torch.from_numpy(segs),
        torch.from_numpy(pos), segment_starts=tuple(offs))
    assert tuple(tl.shape) == jl.shape and tuple(tk.shape) == jk.shape
    rows = np.concatenate([np.arange(o, o + len(p))
                           for o, p in zip(offs, prompts)])
    _close(tl[0, rows], np.asarray(jl)[0, rows], dt, "logits")
    _close(tk[:, :, :, rows], np.asarray(jk)[:, :, :, rows], dt, "k")
    _close(tv[:, :, :, rows], np.asarray(jv)[:, :, :, rows], dt, "v")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_jagged_matches_jax(dt):
    """Rows below each length against JAX's row-loop kernel; the port's
    rows past a length stay finite."""
    jcfg, jp, tcfg, tp = _models(dt)
    lengths = (300, 130, 1)
    toks = pad_prompts(_prompts(lengths, 2), PS)
    jl, jk, jv = JI.prefill_forward_jagged(jcfg, jp, jnp.asarray(toks),
                                           jnp.asarray(lengths, jnp.int32))
    tl, tk, tv = TI.prefill_forward_jagged(tcfg, tp, torch.from_numpy(toks),
                                           torch.tensor(lengths))
    assert tuple(tl.shape) == jl.shape == (3, 384, 256)
    for b, L in enumerate(lengths):
        _close(tl[b, :L], np.asarray(jl)[b, :L], dt, f"logits {b}")
        _close(tk[:, b, :, :L], np.asarray(jk)[:, b, :, :L], dt, f"k {b}")
        _close(tv[:, b, :, :L], np.asarray(jv)[:, b, :, :L], dt, f"v {b}")
    assert bool(torch.isfinite(tl).all() and torch.isfinite(tk).all())


def _admit(engine_cls, request_cls, cfg, params, mode, prompts, **kw):
    eng = engine_cls(cfg, params, num_pages=64, page_size=PS, max_seqs=4,
                     pages_per_seq=4, **kw)
    reqs = [request_cls(list(p), max_new_tokens=5) for p in prompts]
    if mode.startswith("packed"):
        eng.add_requests_packed(reqs, pack_bucket=mode.split("-")[1])
    elif mode == "jagged":
        eng.add_requests_jagged(reqs)
    else:
        eng.add_requests(reqs)
    return eng, reqs


@functools.lru_cache(maxsize=None)
def _jax_run(mode):
    jcfg, jp, _, _ = _models()
    eng, reqs = _admit(JEngine, JRequest, jcfg, jp, mode,
                       _prompts((7, 130, 61), 23))
    pages = [np.asarray(p) for p in eng.cache.pages]
    table = eng.cache.page_table.copy()
    eng.steps(4)
    return [eng.requests[r.slot].generated for r in reqs], pages, table


@pytest.mark.parametrize("mode", ["batched", "packed-page", "packed-pow2",
                                  "jagged"])
def test_admission_greedy_tokens_match_batched_and_jax(mode):
    """Mirrors tests/test_model.py::test_packed_admission_matches_batched:
    every admission mode gives the batched path's greedy tokens, and the
    JAX engine's for the same mode; the pages admission wrote (rows below
    each length) agree with JAX's at the fp32 gate, and pow2 padding never
    reaches a slot's pages."""
    _, _, tcfg, tp = _models()
    prompts = _prompts((7, 130, 61), 23)
    eng, reqs = _admit(TEngine, Request, tcfg, tp, mode, prompts,
                       device="cpu")
    jtoks, jpages, jtable = _jax_run(mode)
    np.testing.assert_array_equal(eng.cache.page_table, jtable)
    for li, pages in enumerate(eng.cache.pages):
        for r in reqs:
            L = len(r.prompt)
            ids = eng.cache.page_table[r.slot, :-(-L // PS)]
            got = pages[:, ids].reshape(2, -1, 2, PS, 128)
            want = jpages[li][:, ids].reshape(2, -1, 2, PS, 128)
            for half in range(2):                       # K rows, V rows
                _close(got[:, :, half].reshape(2, -1, 128)[:, :L],
                       want[:, :, half].reshape(2, -1, 128)[:, :L], "f32",
                       f"layer {li} slot {r.slot}")
    eng.steps(4)
    got = [eng.requests[r.slot].generated for r in reqs]
    assert got == jtoks
    assert got == _jax_run("batched")[0]
    assert all(len(g) == 5 for g in got)


def test_packed_bucket_and_window_are_checked():
    _, _, tcfg, tp = _models()
    eng = TEngine(tcfg, tp, num_pages=8, page_size=PS, max_seqs=2,
                  pages_per_seq=2, device="cpu")
    with pytest.raises(ValueError, match="pack_bucket"):
        eng.add_requests_packed([Request([1, 2], 2)], pack_bucket="exact")
    assert not eng.requests and len(eng.cache.free_pages) == 7
    eng.cfg = type("Windowed", (), {"attn_window": 64})()
    for admit in (eng.add_requests_packed, eng.add_requests_jagged):
        with pytest.raises(ValueError, match="add_requests"):
            admit([Request([1, 2], 2)])


def test_pack_prompts_layout():
    """Offsets, segment ids and restarting positions (engine.py:143-165)."""
    toks, segs, pos, offs = pack_prompts([[5] * 3, [6] * 130, [7]], 128,
                                         "pow2")
    assert offs == [0, 128, 384] and toks.shape == (1, 512)
    assert segs[0, 0] == 1 and segs[0, 383] == 2 and segs[0, 511] == 3
    assert pos[129] == 1 and pos[384] == 0 and pos[383] == 255
    assert toks[0, :4].tolist() == [5, 5, 5, 0]
    _, _, _, offs = pack_prompts([[5] * 3, [6] * 130, [7]], 128, "page")
    assert offs == [0, 128, 384]
