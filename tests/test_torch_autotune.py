"""The port's FlashConfig, autotuner and benchmark helpers on the CPU.

Mirrors tests/test_aux.py's autotune tests (test_autotune_flash_config,
test_autotune_candidates_cover_tri_family): explicit candidates give a
winner among them, memoized, that round-trips through save_cache /
load_cache and whose output equals JAX's flash_attention (its default
config, interpret mode) at fp32 2e-5 / bf16 2e-2; the default candidate
sets are the run-time choices of ops/configs.py::FlashConfig. Also: a
config the check refuses raises ValueError (and is dropped by the
autotuner before timing), a JAX cache does not load, attention_flops is
JAX's, and every `config=` entry (flash, quantized, row loop, the
context-parallel modes and sharded flash in a world of 2 gloo ranks) gives
the same CPU output as without it. Inputs come from numpy seeds.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as RK
from tiny_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from tiny_flash_attention_tpu.utils import autotune as JAT
from tiny_flash_attention_tpu.utils.benchmarking import (
    attention_flops as jax_flops)
from tiny_flash_attention_tpu_torch import FlashConfig
from tiny_flash_attention_tpu_torch.ops import configs
from tiny_flash_attention_tpu_torch.ops.configs import default_config
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, fwd_config, fwd_f32_split)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from tiny_flash_attention_tpu_torch.ops.flash_quant import (
    flash_attention_quantized)
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop)
from tiny_flash_attention_tpu_torch.ops.quant import quantize_kv
from tiny_flash_attention_tpu_torch.parallel.world import run_world
from tiny_flash_attention_tpu_torch.utils import autotune as AT
from tiny_flash_attention_tpu_torch.utils.benchmarking import (
    attention_flops, run_benchmark)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# a config off every default: the f32 runs and the bf16 instance
OFF = FlashConfig(narrow_products=False, f32_split=1)


def _qkv(seed, b, hq, hkv, n, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((b, h, n, d), np.float32)
            for h in (hq, hkv, hkv))
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.fixture(autouse=True)
def _fresh_cache():
    AT._CACHE.clear()
    yield
    AT._CACHE.clear()


@pytest.mark.parametrize("dtype,d,cands", [
    (torch.float32, 64, [FlashConfig(f32_split=1), FlashConfig(f32_split=4)]),
    (torch.bfloat16, 80, [FlashConfig(narrow_products=True),
                          FlashConfig(narrow_products=False)]),
])
def test_autotune_flash_config(tmp_path, dtype, d, cands):
    """Explicit candidates: the winner is one of them, memoized (the same
    object, nothing timed again), its output JAX's flash_attention's (the
    JAX default config, interpret mode) at the dtype's gate, and it
    round-trips through the persisted cache."""
    q, k, v = _qkv(0, 1, 4, 2, 256, d, dtype)
    cfg = AT.autotune_flash_config(q, k, v, causal=True, rounds=1,
                                   candidates=cands)
    assert cfg in cands and len(AT.last_timings) == 2
    timed = list(AT.last_timings)
    assert AT.autotune_flash_config(q, k, v, causal=True) is cfg
    assert AT.last_timings == timed
    got = flash_attention(q, k, v, causal=True, config=cfg)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_flash(*(jnp.asarray(x.float().numpy(), jdt)
                       for x in (q, k, v)), causal=True)
    err = float(np.max(np.abs(got.float().numpy()
                              - np.asarray(want, np.float32))))
    assert err <= TOL[dtype], err
    path = str(tmp_path / "tune.json")
    AT.save_cache(path)
    AT._CACHE.clear()
    assert AT.load_cache(path) == 1
    assert AT.autotune_flash_config(q, k, v, causal=True) == cfg


def test_autotune_candidates_are_the_runtime_choices():
    """f32 (and fp16): the split at the default, half, twice, four times
    and the whole kv length, those that give distinct runs, the default
    first; bf16 at head dims in (64, 96] read in place: both instances;
    elsewhere bf16 has one candidate, the default."""
    base = default_config(torch.float32, 256, 2048, 2048)
    qs, ks = (1, 8, 2048, 256), (1, 1, 2048, 256)
    cands = AT._candidates(base, qs, ks, torch.float32, True)
    assert cands[0] == base
    assert [c.f32_split for c in cands] == [5, 2, 10, 20, 32]
    runs = [AT._f32_runs(c, qs, 2048, True) for c in cands]
    # half the default needs more merge slots than FLASH_FWD_F32_MAX_SLOTS:
    # the rule
    # lengthens its runs to 9 tiles
    assert runs == [10, 9, 20, 40, 64] and 64 == 2048 // 32
    assert AT._candidates(base, qs, ks, torch.float16, True) == cands
    # where the q tiles alone fill the card no split is made: one candidate
    big = AT._candidates(base, (8, 32, 4096, 128), (8, 8, 4096, 128),
                         torch.float32, True)
    assert big == [base]
    for d in (72, 80, 96):
        two = AT._candidates(base, (1, 8, 512, d), (1, 2, 512, d),
                             torch.bfloat16, True)
        assert [c.narrow_products for c in two] == [True, False]
        assert all(dataclasses.replace(c, narrow_products=True) == base
                   for c in two)
    for d in (64, 100, 128, 192, 256):
        assert AT._candidates(base, (1, 8, 512, d), (1, 2, 512, d),
                              torch.bfloat16, True) == [base]


def test_default_config_is_todays_choice(monkeypatch):
    """default_config is FlashConfig(): the narrow instances and runs of 5
    kv tiles, the two choices a config makes; fwd_f32_split follows the
    config's split and reads the module's two bounds at each call."""
    cfg = default_config(torch.float32, 128, 1024, 1024)
    assert cfg == FlashConfig() == FlashConfig(narrow_products=True,
                                               f32_split=5)
    assert [f.name for f in dataclasses.fields(FlashConfig)] == [
        "narrow_products", "f32_split"]
    assert fwd_f32_split(1024, 1024, causal=True, n_bh=8, config=cfg) == 5
    assert fwd_f32_split(1024, 1024, causal=True, n_bh=8,
                         config=FlashConfig(f32_split=3)) == 3
    monkeypatch.setattr(configs, "FLASH_FWD_F32_SPLIT_BELOW", 0)
    assert fwd_f32_split(1024, 1024, causal=True, n_bh=8, config=cfg) == 16
    assert configs.bwd_f32_split(256) == 2 * configs.FLASH_BWD_F32_SPLIT
    assert fwd_config(torch.float32, head_dim=256).block_n == 32


@pytest.mark.parametrize("bad", [
    FlashConfig(f32_split=0), FlashConfig(f32_split=-3),
    FlashConfig(narrow_products=1), FlashConfig(narrow_products=None),
    FlashConfig(f32_split=2.5), JAT.FlashConfig(), "worklist"])
def test_refused_config_raises(bad):
    """A config the kernels cannot run (a run below one tile, a wrong
    type, JAX's config of TPU tiles) raises ValueError
    in every entry before any launch; the autotuner drops it before
    timing, and raises when nothing is left."""
    q, k, v = _qkv(1, 1, 2, 2, 64, 64)
    kq, vq = quantize_kv(k, v, "int8")
    lse = torch.zeros((1, 2, 64))
    for call in (
            lambda: flash_attention(q, k, v, causal=True, config=bad),
            lambda: flash_attention_quantized(q, kq, vq, config=bad),
            lambda: flash_attention_rowloop(q, k, v, causal=True,
                                            config=bad),
            lambda: flash_attention_bwd(q, k, v, q, lse, q, causal=True,
                                        config=bad)):
        with pytest.raises(ValueError):
            call()
    good = FlashConfig(f32_split=2)
    assert AT.autotune_flash_config(q, k, v, rounds=1,
                                    candidates=[bad, good]) is good
    assert [c for c, _ in AT.last_timings] == [good]
    AT._CACHE.clear()
    with pytest.raises(ValueError, match="refused every candidate"):
        AT.autotune_flash_config(q, k, v, rounds=1, candidates=[bad])


def test_launch_failure_raises_not_skipped(monkeypatch):
    """A candidate that raises when it runs makes the autotuner raise:
    JAX skips a failed compile, the port skips nothing."""
    from tiny_flash_attention_tpu_torch.ops import flash as F

    def failing(*a, **kw):
        raise RuntimeError("launch failed")

    q, k, v = _qkv(2, 1, 2, 2, 64, 64)
    monkeypatch.setattr(F, "flash_attention_plain", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        AT.autotune_flash_config(q, k, v, rounds=1)
    assert not AT._CACHE


def test_jax_cache_does_not_load(tmp_path):
    """A cache JAX's save_cache wrote names TPU tiles: load_cache raises
    and loads nothing; a row with a value the check refuses raises too."""
    key = ((1, 8, 2048, 128), (1, 2, 2048, 128), "bfloat16", True, None,
           "TPU v5 lite")
    JAT._CACHE.clear()
    JAT._CACHE[key] = JAT.FlashConfig(kernel="tri", tri_sub=512)
    path = str(tmp_path / "jax.json")
    try:
        JAT.save_cache(path)
    finally:
        JAT._CACHE.clear()
    with pytest.raises(ValueError, match="JAX cache"):
        AT.load_cache(path)
    assert not AT._CACHE
    AT._CACHE[key] = FlashConfig(f32_split=3)
    AT.save_cache(path)
    AT._CACHE.clear()
    text = open(path).read().replace('"f32_split": 3', '"f32_split": 0')
    open(path, "w").write(text)
    with pytest.raises(ValueError):
        AT.load_cache(path)
    assert not AT._CACHE


def test_attention_flops_matches_jax():
    for bs, h, ql, kl, d, causal in itertools.product(
            (1, 3), (1, 8, 32), (1, 127, 2048), (1, 4096, 8191),
            (64, 96, 256), (False, True)):
        assert attention_flops(bs, h, ql, kl, d, causal) == jax_flops(
            bs, h, ql, kl, d, causal)


def test_run_benchmark_finds_the_tensors_device():
    """The timing follows the first tensor argument: a QuantizedTensor's
    values count, a bool or config before it does not (a tensor's own
    `values` method is not mistaken for a payload)."""
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        tensor_device)

    meta = torch.zeros((1, 2, 8, 64), device="meta")
    kq, _ = quantize_kv(torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 8, 64),
                        "int8")
    assert tensor_device((meta,), {}) == torch.device("meta")
    assert tensor_device((True, OFF), {"x": meta}) == torch.device("meta")
    assert tensor_device((kq,), {}) == torch.device("cpu")
    assert tensor_device((1, "a"), {"config": OFF}) is None


def test_run_benchmark_on_the_cpu():
    """The host clock on CPU tensors: JAX's keys, positive times, the
    warm-up calls made."""
    calls = []
    r = run_benchmark(lambda x: calls.append(1) or x * 2, torch.ones(4),
                      warmup=2, rounds=3)
    assert len(calls) == 5 and r["device"] == "cpu"
    assert 0 <= r["min_ms"] <= r["median_ms"] <= r["mean_ms"] * 3
    assert {"mean_ms", "min_ms", "median_ms", "spread"} <= set(r)


def test_config_entries_same_cpu_output():
    """flash_attention (and its gradients), flash_attention_quantized and
    flash_attention_rowloop give the same CPU output with a config off
    every default as without one."""
    q, k, v = _qkv(3, 1, 4, 2, 200, 64)
    for x in (q, k, v):
        x.requires_grad_()
    outs, grads = [], []
    for kw in ({}, {"config": OFF}):
        out = flash_attention(q, k, v, causal=True, window=50, **kw)
        outs.append(out)
        grads.append(torch.autograd.grad(out.sum(), (q, k, v)))
    assert torch.equal(*outs)
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    q, k, v = (x.detach() for x in (q, k, v))
    kq, vq = quantize_kv(k, v, "fp8")
    a, b = (flash_attention_quantized(q, kq, vq, causal=True, **kw)
            for kw in ({}, {"config": OFF}))
    assert torch.equal(a, b)
    lens = torch.tensor([200])
    a, b = (flash_attention_rowloop(q, k, v, causal=True, seq_lengths=lens,
                                    **kw)
            for kw in ({}, {"config": OFF}))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_parallel_config_entries_same_cpu_output():
    """Ring (causal, non-causal), zigzag, Ulysses, all-gather and sharded
    flash take `config=` (JAX's signatures) and give the same output with
    it as without it, in a world of 2 gloo ranks."""
    inputs = [x.numpy() for x in _qkv(4, 1, 4, 2, 256, 64)]
    per_rank = run_world(RK.config_entries, 2, backend="gloo",
                         device_type="cpu", args=(inputs, OFF),
                         timeout_s=120.0)
    for out in per_rank:
        assert set(out) == {"ring", "ring non-causal", "ulysses",
                            "allgather", "zigzag", "sharded"}
        for name, (plain, tuned) in out.items():
            assert torch.equal(plain, tuned), name
