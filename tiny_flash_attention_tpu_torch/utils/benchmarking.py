"""CUDA-event timing of the card's work: warm up, then the median of N calls.

`run_benchmark` is the JAX package's entry (tiny_flash_attention_tpu/utils/
benchmarking.py) over `cuda_time_ms` on the card and the host clock on the
CPU; `attention_flops` its FLOP count.

Before each timed call the L2 cache is flushed by writing a buffer twice its
size, so a kernel whose inputs would fit in L2 (the H100 has 50 MB) is
timed reading device memory, as the engine's caller finds them. Then a spin
kernel is queued: while the device spins, the host records the start event,
enqueues every launch of the call and records the end event, so the window
between the events holds the call's device work and none of its Python
time (validation, allocation, the ctypes call). A call whose enqueue
outlasts the spin is timed again behind a longer one. The JAX version's
relay fence logic has no counterpart here: events time the device directly.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

L2_FLUSH_BYTES = 128 * 2**20
WARMUP = 3
SPIN_MS = 2.0          # device time queued ahead of each timed call
MAX_SPIN_MS = 256.0

_cycles_per_ms: float | None = None


def _spin_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per ms, measured once."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        cycles = 10**7
        torch.cuda._sleep(cycles // 10)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _cycles_per_ms = cycles / start.elapsed_time(end)
    return _cycles_per_ms


def cuda_time_ms(fn: Callable[[], object], *, iters: int = 10) -> dict:
    """Device time of fn() on the card; returns median, min and max in ms."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms times the card; CUDA is absent")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    per_ms = _spin_cycles_per_ms()
    spin_ms = SPIN_MS
    for _ in range(WARMUP):
        fn()
    times = []
    while len(times) < iters:
        flush.zero_()
        torch.cuda._sleep(int(spin_ms * per_ms))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms < spin_ms:
            times.append(start.elapsed_time(end))
        elif spin_ms < MAX_SPIN_MS:
            spin_ms *= 2
        else:
            raise RuntimeError(f"enqueueing the call took {host_ms:.1f} ms: "
                               "its device time cannot be separated from "
                               "the host's")
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "iters": iters, "times": times}


def tensor_device(args, kwargs):
    """The device of the first tensor among the arguments (a
    QuantizedTensor's values included), or None."""
    for x in (*args, *kwargs.values()):
        if not isinstance(x, torch.Tensor):
            x = getattr(x, "values", None)
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def run_benchmark(fn: Callable, *args, warmup: int = 5, rounds: int = 3,
                  **kwargs) -> dict:
    """Times fn(*args, **kwargs): `warmup` calls, then `rounds` timed ones.
    On CUDA tensors each round is the device time of one call by
    `cuda_time_ms` (CUDA events, the L2 flushed, a spin queued ahead); on
    CPU tensors the host clock around the call. Returns mean_ms, min_ms,
    median_ms and spread ((max - min) / median), as JAX's does, and
    `device`, the type of the first tensor argument's device
    (`tensor_device`; "cpu" without one). JAX's `fence_ms`, `epochs` and
    `chained` have no counterpart: events time the device itself, so no
    relay fence is subtracted and no calls are chained into one
    dispatch."""
    rounds = max(1, rounds)
    for _ in range(max(warmup, 0)):
        fn(*args, **kwargs)
    device = tensor_device(args, kwargs)
    if device is not None and device.type == "cuda":
        samples = cuda_time_ms(lambda: fn(*args, **kwargs),
                               iters=rounds)["times"]
    else:
        samples = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            samples.append((time.perf_counter() - t0) * 1e3)
    samples = sorted(samples)
    median = samples[len(samples) // 2]
    return {"mean_ms": sum(samples) / len(samples), "min_ms": samples[0],
            "median_ms": median,
            "spread": (samples[-1] - samples[0]) / median if median else 0.0,
            "device": "cpu" if device is None else device.type}


def attention_flops(bs: int, heads: int, q_len: int, kv_len: int, d: int,
                    causal: bool = False) -> int:
    """Forward attention FLOPs: two products of 2 q_len kv_len d each, half
    of them causal (the JAX package's count)."""
    f = 4 * bs * heads * q_len * kv_len * d
    return f // 2 if causal else f
