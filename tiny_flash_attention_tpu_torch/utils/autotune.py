"""Measured choice of the flash forward's run-time config.

Port of tiny_flash_attention_tpu/utils/autotune.py. There the candidates are
TPU tile geometries (block sizes, kv splits, the triangle kernels); the
port's tiles are fixed when the kernels are built, so its candidates are
the choices a `FlashConfig` makes at run time (ops/configs.py), bracketing
`default_config`, each timed on the live device and the fastest kept, per
(q shape, k shape, dtype, causal, window, device name):

    cfg = autotune_flash_config(q, k, v, causal=True)
    out = flash_attention(q, k, v, causal=True, config=cfg)

Winners persist with save_cache / load_cache (JSON, the JAX rows' schema
with the port's config fields). A JAX cache names TPU tiles and does not
load. On the CPU the candidates all run the plain version, which no config
changes, and are timed on the host clock.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from tiny_flash_attention_tpu_torch.ops.configs import (
    FLASH_FWD_F32, FlashConfig, check_config, default_config)
from tiny_flash_attention_tpu_torch.ops.dims import flash_width

_CACHE: dict = {}
# (config, run_benchmark's result) of every candidate of the last tuning
# run, in the order timed
last_timings: list = []

_FIELDS = tuple(f.name for f in dataclasses.fields(FlashConfig))


def _device_name(x: torch.Tensor) -> str:
    return torch.cuda.get_device_name(x.device) if x.is_cuda else "cpu"


def _f32_runs(config: FlashConfig, q_shape, kv_len: int, causal: bool):
    """The f32 forward's run length that `config` gives at this launch."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        fwd_config, fwd_f32_split)

    bs, hq, q_len, d = q_shape
    return fwd_f32_split(q_len, kv_len, causal=causal, n_bh=bs * hq,
                         config=config,
                         cfg=fwd_config(torch.float32, head_dim=d))


def _candidates(base: FlashConfig, q_shape, k_shape, dtype,
                causal: bool = True) -> list:
    """The run-time choices that differ at this launch, `base` first.
    f32 (and fp16, which computes in f32): `f32_split` at the base, half,
    twice and four times it, and at the kv tiles of the whole length (no
    split), kept where they give distinct runs. bf16 at a head_dim in (64,
    96] read in place, where `narrow_products` changes the instance
    (ops/dims.py::flash_width): both instances. Elsewhere bf16 has one
    candidate: its kernels take no other run-time choice."""
    kv_len, d = k_shape[2], q_shape[3]
    if dtype == torch.bfloat16:
        if flash_width(d, True) != flash_width(d, False):
            return [base, dataclasses.replace(
                base, narrow_products=not base.narrow_products)]
        return [base]
    s = base.f32_split
    whole = -(-kv_len // FLASH_FWD_F32.block_n)
    out, seen = [], set()
    for split in (s, max(1, s // 2), 2 * s, 4 * s, whole):
        cand = dataclasses.replace(base, f32_split=split)
        runs = _f32_runs(cand, q_shape, kv_len, causal)
        if runs not in seen:
            seen.add(runs)
            out.append(cand)
    return out


def autotune_flash_config(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    window: Optional[int] = None,
    rounds: int = 3,
    candidates=None,
    verbose: bool = False,
) -> FlashConfig:
    """Times each candidate config of `flash_attention` on q, k, v where
    they lie (`utils/benchmarking.py::run_benchmark`: device time on the
    card, the host clock on the CPU) and returns the fastest by min_ms.
    Memoized per (q shape, k shape, dtype, causal, window, device name) for
    the process's life (save_cache / load_cache persist it): a second call
    launches nothing and returns the same object.

    `candidates` default to `_candidates` around `default_config`
    (FlashConfig()). A
    candidate that `check_config` refuses is dropped before timing (every
    candidate refused raises ValueError); one that raises at launch makes
    this raise: no candidate is skipped for failing."""
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        run_benchmark)

    bs, hq, q_len, d = q.shape
    kv_len = k.shape[2]
    key = (tuple(q.shape), tuple(k.shape), str(q.dtype), causal, window,
           _device_name(q))
    if key in _CACHE:
        return _CACHE[key]
    base = default_config(q.dtype, d, q_len, kv_len, causal=causal)
    if candidates is None:
        candidates = _candidates(base, q.shape, k.shape, q.dtype, causal)
    kept = []
    for cfg in candidates:
        try:
            kept.append(check_config(cfg))
        except ValueError as e:
            if verbose:
                print(f"autotune: {cfg} refused: {e}")
    if not kept:
        raise ValueError("autotune: the check refused every candidate")
    last_timings.clear()
    best, best_ms = None, float("inf")
    for cfg in kept:
        r = run_benchmark(flash_attention, q, k, v, causal=causal,
                          window=window, config=cfg, rounds=rounds)
        last_timings.append((cfg, r))
        if verbose:
            print(f"autotune: {cfg}: {r['min_ms']:.4f} ms")
        if r["min_ms"] < best_ms:
            best, best_ms = cfg, r["min_ms"]
    _CACHE[key] = best
    return best


def save_cache(path: str) -> None:
    """Writes the tuned winners as JSON rows (q_shape, k_shape, dtype,
    causal, window, device_kind, config), so a serving job skips tuning."""
    rows = []
    for (qs, ks, dtype, causal, window, kind), cfg in _CACHE.items():
        rows.append({"q_shape": list(qs), "k_shape": list(ks),
                     "dtype": dtype, "causal": causal, "window": window,
                     "device_kind": kind,
                     "config": dataclasses.asdict(cfg)})
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def load_cache(path: str) -> int:
    """Loads winners that save_cache wrote; returns the number of rows. A
    row whose config has other fields than the port's FlashConfig (a JAX
    cache's TPU tiles: block_q, block_kv, kv_splits, kernel, tri_sub) or a
    value `check_config` refuses raises ValueError, and nothing of the
    file is loaded."""
    with open(path) as f:
        rows = json.load(f)
    loaded = {}
    for r in rows:
        fields = set(r["config"])
        if fields != set(_FIELDS):
            raise ValueError(
                f"{path}: a config of fields {sorted(fields)} is not the "
                f"port's FlashConfig {list(_FIELDS)} (a JAX cache names "
                f"TPU tiles and does not load)")
        key = (tuple(r["q_shape"]), tuple(r["k_shape"]), r["dtype"],
               r["causal"], r["window"], r["device_kind"])
        loaded[key] = check_config(FlashConfig(**r["config"]))
    _CACHE.update(loaded)
    return len(rows)
