"""utils/profiling.py of the port against the JAX package's.

`roofline` and `RooflineReport` give JAX's fields and text for the same
inputs; `count_flops` counts a matmul at 2*M*N*K as XLA's cost model does
(tests/test_aux.py::test_count_flops_matmul), the port's plain attention
at its two products, and bytes as the tensors each operation moves;
`trace` writes a trace file.
"""

import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from tiny_flash_attention_tpu.utils import profiling as JP
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention_plain
from tiny_flash_attention_tpu_torch.utils import profiling as TP

ROOFLINE_CASES = [
    (10**12, 10**9, 0.01),          # attention-like: compute-bound
    (10**9, 10**9, 0.01),           # decode-like: memory-bound
    (2 * 2 * 8 * 2048 * 2048 * 128, 50_331_648, 1.0e-4),
    (0, 1, 1.0),
]


@pytest.mark.parametrize("flops,nbytes,seconds", ROOFLINE_CASES)
def test_roofline_matches_jax(flops, nbytes, seconds):
    peaks = {"peak_tflops": TP.H100_PEAK_TFLOPS_BF16,
             "peak_gbs": TP.H100_PEAK_GBS}
    got = TP.roofline(flops, nbytes, seconds)
    want = JP.roofline(flops, nbytes, seconds, **peaks)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)
    # other peaks pass through as in JAX (its v5e defaults)
    assert dataclasses.asdict(TP.roofline(
        flops, nbytes, seconds, peak_tflops=JP.V5E_PEAK_TFLOPS_BF16,
        peak_gbs=JP.V5E_PEAK_GBS)) == dataclasses.asdict(
            JP.roofline(flops, nbytes, seconds))


def test_default_peaks_are_the_h100s():
    assert (TP.H100_PEAK_TFLOPS_BF16, TP.H100_PEAK_GBS) == (989.0, 3350.0)
    r = TP.roofline(flops=989 * 10**12, bytes_accessed=10**9, seconds=1.0)
    assert r.compute_frac == pytest.approx(1.0)
    assert r.bound == "compute"


def test_count_flops_matmul_matches_jax():
    m, k, n = 128, 256, 64
    got = TP.count_flops(lambda a, b: a @ b, torch.zeros(m, k),
                         torch.zeros(k, n))
    want = JP.count_flops(lambda a, b: a @ b, jnp.zeros((m, k)),
                          jnp.zeros((k, n)))
    assert got["flops"] == want["flops"] == 2 * m * k * n
    # each input read once, the output written once
    assert got["bytes_accessed"] == 4 * (m * k + k * n + m * n)


def test_count_flops_of_plain_attention():
    """The plain forward's two products: 2 * S * S * d each, per head."""
    b, h, s, d = 1, 2, 128, 64
    q = torch.zeros(b, h, s, d)
    got = TP.count_flops(lambda q: flash_attention_plain(
        q, q, q, causal=True, sm_scale=d ** -0.5), q)
    assert got["flops"] == 4 * b * h * s * s * d
    assert got["bytes_accessed"] >= 4 * q.numel() * 4


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    data = json.loads((tmp_path / "trace.json").read_text())
    assert data["traceEvents"], "trace recorded no events"
