"""Profiling and roofline accounting.

Counterpart of tiny_flash_attention_tpu/utils/profiling.py:

  * `trace(logdir)` -- a torch.profiler trace of a region, written into
    logdir as a Chrome trace (`trace.json`; chrome://tracing or Perfetto).
  * `count_flops(fn, *args)` -- flops and bytes of `fn(*args)`, counted as
    it runs: flops by torch.utils.flop_counter.FlopCounterMode (2*M*N*K for
    a matmul, as XLA counts it), bytes as the tensors each dispatched
    operation reads and writes (torch has no cost model of a compiled
    program; views move nothing and are not counted).
  * `roofline(...)` -- places a measured run against the card's compute
    and memory roofs and says which wall it is against.

A kernel launched through ctypes (every kernel of the port) is opaque to
both counts, as a Pallas kernel is to XLA's: pass `roofline` analytic
counts for it. The default peaks are one H100 SXM's (80GB HBM3, dense bf16
tensor cores, HBM3 bandwidth) at its full 700 W power limit; a card set
below it runs slower under load.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

H100_PEAK_TFLOPS_BF16 = 989.0
H100_PEAK_GBS = 3350.0


@contextlib.contextmanager
def trace(logdir: str):
    """Traces a region with torch.profiler (the card's kernels too where
    CUDA is present): `with trace('/tmp/tb'): ...` writes
    logdir/trace.json."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class _ByteCounter(TorchDispatchMode):
    """Adds the bytes of every tensor each operation reads and writes."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.nbytes += sum(t.nbytes for t in tree_flatten(
                (args, kwargs, out))[0] if isinstance(t, torch.Tensor))
        return out


def count_flops(fn, *args, **kwargs) -> dict:
    """Flops and bytes of one `fn(*args, **kwargs)` run (forward only, no
    autograd). Returns {'flops': float, 'bytes_accessed': float}."""
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter()
    with torch.no_grad(), flops, counter:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.nbytes)}


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    achieved_tflops: float
    achieved_gbs: float
    compute_frac: float      # fraction of the compute roof
    memory_frac: float       # fraction of the memory roof
    bound: str               # "compute" | "memory"
    arithmetic_intensity: float   # flops / byte
    ridge_intensity: float        # peak_flops / peak_bytes

    def __str__(self):
        return (f"{self.achieved_tflops:.1f} TFLOP/s "
                f"({100 * self.compute_frac:.0f}% of compute roof), "
                f"{self.achieved_gbs:.0f} GB/s "
                f"({100 * self.memory_frac:.0f}% of memory roof), "
                f"AI={self.arithmetic_intensity:.1f} flop/B "
                f"-> {self.bound}-bound")


def roofline(flops: int, bytes_accessed: int, seconds: float, *,
             peak_tflops: float = H100_PEAK_TFLOPS_BF16,
             peak_gbs: float = H100_PEAK_GBS) -> RooflineReport:
    """Places one measured run on the (compute, memory) roofline."""
    tf = flops / seconds / 1e12
    gbs = bytes_accessed / seconds / 1e9
    ai = flops / max(bytes_accessed, 1)
    ridge = peak_tflops * 1e3 / peak_gbs   # flops per byte at the ridge
    return RooflineReport(
        achieved_tflops=tf,
        achieved_gbs=gbs,
        compute_frac=tf / peak_tflops,
        memory_frac=gbs / peak_gbs,
        bound="compute" if ai >= ridge else "memory",
        arithmetic_intensity=ai,
        ridge_intensity=ridge,
    )
