#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from tiny_flash_attention_tpu_torch/csrc/
with nvcc and holds each kernel against its plain PyTorch version on the
card (the flash forward with and without segment ids, with the sliding
window, and its jagged row-loop mode, the flash backward's kernels (bf16:
prep, main, post; f32: dq, dk/dv) with the window, segment ids and
segment_starts, the paged decode over bf16 and int8 pages and its ring mode, the
page append, the weight-only quantized matmul, the FA1 forward and the
decode over separate K/V page arrays at the shapes of the repo's attention
benchmark). Then it runs the engine benchmark's model (vocab 32768, d_model
1024, 4 layers, 8/2 heads of 128, d_ff 4096, bf16; random weights from a
seed) on its main paths: serving with bf16 pages, two batched admissions
and 67 decode steps; quantized serving (int8 pages, with bf16 and with int8
weights, 8 prompts of 512 and of 7936 tokens, the configurations of
benchmarks/engine_bench.py:190-191,217-218), 64 decode steps each; ragged
admission, the jagged benchmark's 8 prompts (benchmarks/
jagged_prefill_bench.py:41) admitted batched, packed (page and pow2
buckets) and jagged, then 32 decode steps each; the encoder's embed_texts
at 8 x 2048 and 32 x 512 (benchmarks/encoder_bench.py); the same model
with a sliding window of 1024 served from a ring cache (8 prompts of
1792-2048 tokens, 256 decode steps past the ring's capacity); and training,
AdamW steps at batch 4 x seq 2048 and 1 x 8192 (benchmarks/
train_bench.py's configs), the sliding-window model at 1 x 8192 (the swa
train cell) and two f32 steps at 1 x 1024. It fails if a kernel does not
build, launch or agree, if a path did not go through its kernels, if a
path's output disagrees with its plain version, if the train step's loss
is not finite, does not fall, or its gradients disagree with those through
the plain attention, or if a backward through an entry whose JAX kernel
has no VJP does not raise.

Stdout: one line per check, then the kernels' JSON line, then the card's
name and power limit, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA it exits nonzero and prints no result. It imports only torch,
numpy and the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 on the
# CUDA cores (the f32 kernel never uses TF32), HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
PROFILE_STEPS = 8
# The decode kernel and its plain version share their arithmetic (q scaled
# in bf16, p rounded to bf16 before PV), so they agree far inside the
# generic bf16 gate: earlier runs read at most 1.95e-3 on out (one bf16 ulp
# in [0.25, 0.5)) and 9.5e-7 on the LSE.
DECODE_OUT_GATE = 4e-3
DECODE_LSE_GATE = 1e-4
# Engine logits against the plain attention path, as a share of the
# largest |logit|: earlier runs read 0.0391 of 4.688 (0.83 %) at prefill
# and 0.0352 (0.76 %) at the first decode step.
ENGINE_LOGIT_GATE = 1.5e-2
# The backward kernels against their plain version, which repeats their
# rounding points, relative to the largest |gradient|: earlier runs read at
# most 3.45e-3 in bf16 (one bf16 ulp of a result is at most 2^-7 of it,
# 7.8e-3) and 2.24e-6 in f32.
BWD_PLAIN_GATE = {torch.bfloat16: 8e-3, torch.float32: 2e-5}
# ... and against autograd through the f32 plain forward (the oracle of
# tests/test_flash_tri.py:265), at the dtype gates: earlier runs read at
# most 1.24e-2 in bf16 and 2.64e-6 in f32.
BWD_ORACLE_GATE = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# The weight-only quantized matmul kernel against its plain version (an f32
# matmul of the same exact products): the f32 sums differ in order only, so
# the bf16 outputs differ by at most one rounding, 2^-7 of the largest
# |output|.
QMM_GATE = 2.0 ** -7
# The append kernel and its plain version run the same IEEE operations
# (amax, amax / 127, x / scale, round half to even): bit for bit.
# One train step's gradients through the kernels against those through
# attn_impl="reference", per parameter, by relative Frobenius norm: earlier
# runs read 1.89e-2 (bf16 activations round at other points in the two
# attention paths).
TRAIN_GRAD_GATE = 3e-2

# (name, q shape, kv shape, dtype, causal)
FLASH_CASES = [
    ("causal 2048 (tri regime, bench.py headline)", (2, 8, 2048, 128),
     (2, 2, 2048, 128), torch.bfloat16, True),
    ("causal 768 (work-list regime)", (2, 8, 768, 128), (2, 2, 768, 128),
     torch.bfloat16, True),
    ("causal 8192 (tri_block regime)", (1, 8, 8192, 128), (1, 2, 8192, 128),
     torch.bfloat16, True),
    ("non-causal 2048", (2, 8, 2048, 128), (2, 2, 2048, 128),
     torch.bfloat16, False),
    ("decode offset q128/kv2048", (2, 8, 128, 128), (2, 2, 2048, 128),
     torch.bfloat16, True),
    ("causal 512 (the old XLA route)", (2, 8, 512, 128), (2, 2, 512, 128),
     torch.bfloat16, True),
    ("causal 1024 f32", (2, 8, 1024, 128), (2, 2, 1024, 128),
     torch.float32, True),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def _bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _visible_pairs(q, k, causal: bool) -> float:
    """(row, column) pairs the mask lets through, over all heads."""
    b, hq, q_len, _ = q.shape
    kv_len = k.shape[2]
    if causal:
        rows = np.arange(q_len) + (kv_len - q_len) + 1
        pairs = float(np.clip(rows, 0, kv_len).sum())
    else:
        pairs = float(q_len) * kv_len
    return b * hq * pairs


def ragged_bound(q, k, pairs: float, *, tokens=None,
                 int_bytes: int = 0) -> tuple[float, str]:
    """Least time for a forward whose mask lets `pairs` (row, column) pairs
    of one q head through (summed over the batch): 4 * d flops per pair and
    q head; the q, k and v rows of `tokens` tokens (default: all) read
    once, out and the f32 LSE written once, the ids or lengths read once."""
    b, hq, n, d = q.shape
    el = q.element_size()
    rows = b * n if tokens is None else tokens
    nbytes = (rows * (hq + 2 * k.shape[1]) * d * el + q.numel() * el
              + q[..., 0].numel() * 4 + int_bytes)
    return _bound(4.0 * d * hq * pairs, nbytes, q.dtype)


def id_pairs(ids: np.ndarray, causal: bool) -> float:
    """(row, column) pairs with equal ids in (b, n) ids used for q and kv
    alike: the m tokens of one id give m(m+1)/2 causal pairs or m^2."""
    total = 0.0
    for row in ids:
        m = np.unique(row, return_counts=True)[1].astype(np.float64)
        total += float((m * (m + 1) / 2).sum() if causal else (m * m).sum())
    return total


def flash_bound(q, k, causal: bool) -> tuple[float, str]:
    """Least time for the forward: 4 * d flops per visible (row, column)
    pair, q/k/v read once, out and the f32 LSE written once."""
    flops = 4.0 * q.shape[-1] * _visible_pairs(q, k, causal)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + q[..., 0].numel() * 4
    return _bound(flops, nbytes, q.dtype)


def mask_pairs(q, k, causal: bool, window=None, ids=None) -> float:
    """(row, column) pairs the masks let through, over all heads: causal
    with the decode offset, the window, or segment ids of a packed row
    ((b, n) numpy, q_len == kv_len)."""
    if ids is not None:
        return q.shape[1] * id_pairs(ids, causal)
    if window is None:
        return _visible_pairs(q, k, causal)
    b, hq, q_len, _ = q.shape
    kv_len = k.shape[2]
    pos = np.arange(q_len) + (kv_len - q_len)
    seen = np.minimum(pos, kv_len - 1) - np.maximum(pos - window + 1, 0) + 1
    return b * hq * float(np.clip(seen, 0, None).sum())


def bwd_bound(q, k, part: str, pairs: float) -> tuple[float, str]:
    """Least time for the backward or one of its kernels on `pairs`
    visible pairs: 2 * d flops a pair for each product it computes (the
    backward as a whole, and the bf16 main kernel, 5: s, dp, dv, dk, dq;
    the f32 dq kernel 3: s, dp, dq; the f32 dk/dv kernel 4: s, dp, dv, dk),
    each input read once and each output written once. The backward reads
    q, k, v, out, do and the f32 LSE and writes dq, dk, dv. bf16 prep reads
    q, out, do and the LSE and writes qs and the f32 lse2 and delta; main
    reads q, qs, do, k, v, lse2 and delta and writes the f32 accumulators
    (dq of q's size, dk and dv of k's); post reads those and writes dq, dk,
    dv. The f32 kernels read q, do, k, v, the LSE and delta and write their
    gradients."""
    el, rows = q.element_size(), q[..., 0].numel()
    nq, nk = q.numel(), k.numel()
    products, reads, writes = {
        "all": (5, (3 * nq + 2 * nk) * el + rows * 4, (nq + 2 * nk) * el),
        "prep": (0, 3 * nq * el + rows * 4, nq * el + 2 * rows * 4),
        "main": (5, (3 * nq + 2 * nk) * el + 2 * rows * 4,
                 (nq + 2 * nk) * 4),
        "post": (0, (nq + 2 * nk) * 4, (nq + 2 * nk) * el),
        "dq": (3, (2 * nq + 2 * nk) * el + 2 * rows * 4, nq * el),
        "dkv": (4, (2 * nq + 2 * nk) * el + 2 * rows * 4, 2 * nk * el),
    }[part]
    flops = 2.0 * products * q.shape[-1] * pairs
    return _bound(flops, reads + writes, q.dtype)


def decode_bound(q, pages, lengths, table, page_size) -> tuple[float, str]:
    """Least time for one decode call on this data: the K and V rows below
    each (clamped) length read once (int8 pages: with their two 4-byte
    scales), with q, the page ids used, the lengths, out and the LSE;
    4 * d flops per (q head, token)."""
    batch, hq, d = q.shape
    hkv = pages.shape[0]
    n = np.minimum(lengths.cpu().numpy().astype(np.int64),
                   table.shape[1] * page_size)
    tokens = float(n.sum())
    scale_bytes = 8 if pages.dtype == torch.int8 else 0
    nbytes = (tokens * hkv * (2 * d * pages.element_size() + scale_bytes)
              + 2 * q.numel() * q.element_size() + batch * hq * 4
              + batch * 4 + float(np.ceil(n / page_size).sum()) * 4)
    return _bound(4.0 * hq * d * tokens, nbytes, q.dtype)


def instance_registers(ptxas_log: str) -> list:
    """'kernel<template args>: registers' for each kernel instance in a
    ptxas -v log, read from the mangled names, where each name is preceded
    by its length (flash_fwd_bf16_kernel<128,0>: head_dim 128, no
    window)."""
    out = []
    for name, regs in re.findall(
            r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
            ptxas_log, re.S):
        label = name[:60]
        # every digit run and its suffixes: a hash may end in a digit
        for m in re.finditer(r"(?=(\d+)[A-Za-z_])", name):
            start = m.start() + len(m.group(1))
            ident = name[start:start + int(m.group(1))]
            args = re.match(r"I((?:L[a-z]\d+E)+)E", name[start + len(ident):])
            if ident.endswith("_kernel") and args:
                nums = re.findall(r"(\d+)E", args.group(1))
                label = f"{ident}<{','.join(nums)}>"
                break
        out.append(f"{label}: {regs}")
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def gpu_info() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# --- phase 2: flash forward, kernel vs plain ---------------------------------


def check_flash(name, q_shape, kv_shape, dtype, causal, gen, *, iters=10):
    """Kernel vs plain on one shape, then the device times of the kernel,
    the plain version and SDPA (cuda_time_ms: L2 cold, no host time)."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    q = randn(q_shape, dtype, gen)
    k, v = randn(kv_shape, dtype, gen), randn(kv_shape, dtype, gen)
    sm_scale = 1.0 / q_shape[-1] ** 0.5
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale, return_lse=True)
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    atol = tolerance_for(dtype)
    ok = err <= atol and lse_err <= atol and bool(torch.isfinite(out).all())
    mask = None
    if causal and q_shape[2] != kv_shape[2]:
        # SDPA's is_causal aligns the mask top-left; the port's is
        # bottom-right (row i sits at i + kv_len - q_len)
        mask = torch.ones(q_shape[2], kv_shape[2], dtype=torch.bool,
                          device="cuda").tril(kv_shape[2] - q_shape[2])
    sdpa_causal = causal and mask is None
    t_kernel = cuda_time_ms(lambda: flash_attention(q, k, v, causal=causal),
                            iters=iters)["median_ms"]
    t_plain = cuda_time_ms(lambda: flash_attention_plain(
        q, k, v, causal=causal, sm_scale=sm_scale), iters=iters)["median_ms"]
    t_sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=sdpa_causal, enable_gqa=True),
        iters=iters)["median_ms"]
    bound_ms, bound_by = flash_bound(q, k, causal)
    log(f"flash {name}: q{tuple(q_shape)} kv{tuple(kv_shape)} "
        f"{str(dtype).split('.')[-1]} causal={causal} | out err {err:.3e} "
        f"lse err {lse_err:.3e} (gate {atol:.0e}) | kernel {t_kernel:.4f} ms "
        f"plain {t_plain:.4f} ms sdpa {t_sdpa:.4f} ms bound {bound_ms:.4f} ms "
        f"({bound_by}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with plain: {name}")
    return {"max_abs_err": max(err, lse_err), "ms": t_kernel,
            "plain_ms": t_plain, "library_ms": t_sdpa, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": [list(q_shape), list(kv_shape)]}


# --- phase 3: paged decode, kernel vs plain ----------------------------------


def check_decode(name, q, pages, lengths, table, page_size, *, iters=20):
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_attention, fused_paged_decode_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    sm_scale = 1.0 / q.shape[-1] ** 0.5
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=page_size)
    torch.cuda.synchronize()
    ref, ref_lse = fused_paged_decode_plain(q, pages, lengths, table,
                                            page_size=page_size,
                                            sm_scale=sm_scale)
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    ok = (err <= DECODE_OUT_GATE and lse_err <= DECODE_LSE_GATE
          and bool(torch.isfinite(out).all()))
    t_kernel = cuda_time_ms(lambda: fused_paged_decode_attention(
        q, pages, lengths, table, page_size=page_size),
        iters=iters)["median_ms"]
    t_plain = cuda_time_ms(lambda: fused_paged_decode_plain(
        q, pages, lengths, table, page_size=page_size, sm_scale=sm_scale),
        iters=iters)["median_ms"]
    bound_ms, bound_by = decode_bound(q, pages, lengths, table, page_size)
    kv_bytes = bound_ms * 1e-3 * PEAK_BYTES_PER_S
    log(f"decode {name}: q{tuple(q.shape)} pages{tuple(pages.shape)} "
        f"table{tuple(table.shape)} lengths {lengths.tolist()} | out err "
        f"{err:.3e} (gate {DECODE_OUT_GATE:.0e}) lse err {lse_err:.3e} "
        f"(gate {DECODE_LSE_GATE:.0e}) | kernel "
        f"{t_kernel:.4f} ms plain {t_plain:.4f} ms bound {bound_ms:.4f} ms "
        f"({bound_by}) | {kv_bytes / (t_kernel * 1e-3) / 1e9:.1f} GB/s | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode kernel disagrees with plain: {name}")
    return {"max_abs_err": max(err, lse_err), "ms": t_kernel,
            "plain_ms": t_plain, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "shape": [list(q.shape), list(pages.shape), list(table.shape)]}


def decode_inputs(gen, *, batch=8, hq=8, hkv=2, d=128, ps=128, P=32):
    num_pages = batch * P + 8
    q = randn((batch, hq, d), torch.bfloat16, gen)
    pages = randn((hkv, num_pages, 2 * ps, d), torch.bfloat16, gen)
    perm = torch.randperm(num_pages, generator=gen, device="cuda")
    table = perm[:batch * P].reshape(batch, P).to(torch.int32)
    rand = torch.randint(2, P * ps, (batch - 4,), generator=gen,
                         device="cuda")
    lengths = torch.cat([torch.tensor([1, ps - 1, ps, P * ps],
                                      device="cuda"), rand]).to(torch.int32)
    return q, pages, lengths, table


def decode_inputs_int8(gen, *, ps, P, batch=8, hq=8, hkv=2, d=128):
    """int8 pages packed from random bf16 K/V, lengths up to the table."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        pack_paged_cache)

    num_pages = batch * P + 8
    q = randn((batch, hq, d), torch.bfloat16, gen)
    pages = pack_paged_cache(
        randn((hkv, num_pages, ps, d), torch.bfloat16, gen),
        randn((hkv, num_pages, ps, d), torch.bfloat16, gen), "int8")
    perm = torch.randperm(num_pages, generator=gen, device="cuda")
    table = perm[:batch * P].reshape(batch, P).to(torch.int32)
    rand = torch.randint(2, P * ps, (batch - 4,), generator=gen,
                         device="cuda")
    lengths = torch.cat([torch.tensor([1, ps - 1, ps, P * ps],
                                      device="cuda"), rand]).to(torch.int32)
    return q, pages, lengths, table


def check_not_ported_raise() -> None:
    """What the port does not do raises on the card, never falls back; a
    backward through an entry whose JAX kernel has no VJP raises at
    backward() (ROADMAP C1), and never drops the gradient."""
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd)
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop)
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        flash_attention_v1)
    from tiny_flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_attention)
    from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
        quantized_matmul_cuda)

    q = torch.zeros((1, 2, 128, 128), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 128), device="cuda")
    pages = torch.zeros((2, 4, 32, 128), device="cuda", dtype=torch.bfloat16)
    kv_pages = torch.zeros((2, 4, 16, 128), device="cuda",
                           dtype=torch.bfloat16)
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    lengths = torch.tensor([5, 20], dtype=torch.int32, device="cuda")
    qw = Q.quantize_weight(torch.ones((128, 64), device="cuda"))
    no_vjp = {
        "flash_attention(return_lse=True)":
            lambda x: flash_attention(x, q, q, causal=True,
                                      return_lse=True)[0],
        "flash_attention_rowloop":
            lambda x: flash_attention_rowloop(x, q, q, causal=True)[0],
        "flash_attention_v1": lambda x: flash_attention_v1(x, q, q),
        "fused_paged_decode_attention":
            lambda x: fused_paged_decode_attention(
                x[0, :, :2].transpose(0, 1), pages, lengths, table,
                page_size=16)[0],
        "paged_decode_attention":
            lambda x: paged_decode_attention(
                x[0, :, :2].transpose(0, 1), kv_pages, kv_pages, lengths,
                table)[0],
        "quantized_matmul_cuda":
            lambda x: quantized_matmul_cuda(x[0, 0, :8], qw),
    }
    for name, fn in no_vjp.items():
        out = fn(q.clone().requires_grad_())
        try:
            out.float().sum().backward()
        except NotImplementedError as e:
            if "as in JAX" in str(e):
                continue
        raise AssertionError(f"a backward through {name} did not raise")
    log(f"backward through {len(no_vjp)} entries without a JAX VJP raises "
        f"NotImplementedError on the card: ok ({', '.join(no_vjp)})")
    attempts = [
        lambda: flash_attention(q, q.to(torch.int8), q.to(torch.int8)),
        lambda: flash_attention_rowloop(q, q.to(torch.int8),
                                        q.to(torch.int8), causal=True),
        lambda: flash_attention_bwd(q, q.to(torch.int8), q.to(torch.int8),
                                    q, lse, q, causal=True),
    ]
    for fn in attempts:
        try:
            fn()
        except NotImplementedError:
            continue
        raise AssertionError("a feature this slice does not port ran on "
                             "the card")
    log("not-ported features raise NotImplementedError on the card: ok")


# --- phase 3b: the quantized path's kernels, kernel vs plain -----------------

# (name, K, N): every projection of the engine model, at the decode step's
# 8 rows
QMM_SHAPES = [("wq, wo", 1024, 1024), ("wk, wv", 1024, 256),
              ("w_gate, w_up", 1024, 4096), ("w_down", 4096, 1024),
              ("lm_head", 1024, 32768)]


def qmm_bound(m: int, k: int, n: int, x_el: int) -> tuple[float, str]:
    """Least time for one call: the one-byte weight, the f32 scales, x and
    out moved once; 2 * M * K * N operations at the bf16 rate."""
    nbytes = k * n + 4 * n + (m * k + m * n) * x_el
    return _bound(2.0 * m * k * n, nbytes, torch.bfloat16)


def host_us(fn, n: int = 200) -> float:
    """Host time to enqueue one fn() (the wrapper's Python, the launch),
    in microseconds; the device work is waited for afterwards."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def check_qmm(name, m, k, n, fmt, gen, *, iters=20):
    """The kernel vs its plain version at one shape; device times of the
    kernel, the plain version, torch.matmul on the bf16 weight (the
    library yardstick) and the prefill route (cuBLAS on the converted
    payload) at the same rows; the host time of one call (decode is
    host-bound)."""
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
        quantized_matmul_cuda, quantized_matmul_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    x = randn((m, k), torch.bfloat16, gen)
    w = randn((k, n), torch.float32, gen) / k ** 0.5
    qw = Q.quantize_weight(w, fmt)
    got = quantized_matmul_cuda(x, qw)
    torch.cuda.synchronize()
    want = quantized_matmul_plain(x, qw)
    err = max_err(got, want)
    gate = QMM_GATE * float(want.float().abs().max())
    ok = err <= gate and bool(torch.isfinite(got).all())
    wb = w.to(torch.bfloat16)
    t_kernel = cuda_time_ms(lambda: quantized_matmul_cuda(x, qw),
                            iters=iters)["median_ms"]
    t_plain = cuda_time_ms(lambda: quantized_matmul_plain(x, qw),
                           iters=iters)["median_ms"]
    t_lib = cuda_time_ms(lambda: torch.matmul(x, wb), iters=iters)[
        "median_ms"]
    t_route = cuda_time_ms(lambda: Q._large_product(x, qw, x.dtype),
                           iters=iters)["median_ms"]
    bound_ms, bound_by = qmm_bound(m, k, n, x.element_size())
    h_kernel = host_us(lambda: Q.quantized_matmul(x, qw))
    h_lib = host_us(lambda: torch.matmul(x, wb))
    log(f"quant matmul {name}: x({m}, {k}) bf16 @ {fmt} ({k}, {n}) | err "
        f"{err:.3e} (gate {gate:.3e}) | kernel {t_kernel:.4f} ms plain "
        f"{t_plain:.4f} ms prefill route {t_route:.4f} ms torch.matmul bf16 "
        f"weight {t_lib:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) | "
        f"{k * n / (t_kernel * 1e-3) / 1e9:.1f} GB/s of weight | host "
        f"{h_kernel:.1f} us a quantized_matmul call, {h_lib:.1f} us a "
        f"torch.matmul | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"quantized matmul kernel disagrees: {name}")
    return {"max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
            "library_ms": t_lib, "bound_ms": bound_ms, "bound_by": bound_by,
            "route_ms": t_route}


def qmm_row_sweep(gen) -> None:
    """The kernel against the prefill route (cuBLAS on the converted
    payload) by row count: where the route of ops/configs.py::
    QUANT_MATMUL_MAX_ROWS should switch."""
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.configs import (
        QUANT_MATMUL_MAX_ROWS)
    from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
        quantized_matmul_cuda)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    for k, n in ((1024, 4096), (4096, 1024), (1024, 32768)):
        qw = Q.quantize_weight(randn((k, n), torch.float32, gen))
        cells = []
        for m in (1, 2, 4, 8, 16):
            x = randn((m, k), torch.bfloat16, gen)
            t_k = cuda_time_ms(lambda: quantized_matmul_cuda(x, qw),
                               iters=10)["median_ms"]
            t_r = cuda_time_ms(lambda: Q._large_product(x, qw, x.dtype),
                               iters=10)["median_ms"]
            cells.append(f"M {m}: {t_k:.4f}/{t_r:.4f}")
        log(f"quant matmul rows ({k} -> {n}), kernel/prefill route ms: "
            + "; ".join(cells) + f" (route switch above "
            f"{QUANT_MATMUL_MAX_ROWS} rows)")


def qmm_split_sweep(gen) -> None:
    """The kernel's time by K slices (the blocks of a cluster) at every
    engine projection at 8 rows: what ops/configs.py::quant_matmul_splits
    should choose."""
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.configs import (
        quant_matmul_splits)
    from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
        quantized_matmul_cuda)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    for name, k, n in QMM_SHAPES:
        qw = Q.quantize_weight(randn((k, n), torch.float32, gen))
        x = randn((8, k), torch.bfloat16, gen)
        cells = [f"S {s}: " + "{:.4f}".format(cuda_time_ms(
            lambda s=s: quantized_matmul_cuda(x, qw, splits=s),
            iters=10)["median_ms"]) for s in (1, 2, 4, 8)]
        log(f"quant matmul splits {name} ({k} -> {n}), kernel ms: "
            + "; ".join(cells) + f" (chosen: S {quant_matmul_splits(n, k)})")


def append_inputs(gen, *, fmt, ps, batch=8, hkv=2, d=128, P=32):
    from tiny_flash_attention_tpu_torch.ops.paged_fused import page_rows

    num_pages = batch * P + 8
    shape = (hkv, num_pages, page_rows(ps, d, fmt), d)
    if fmt == "int8":
        pages = torch.randint(-127, 128, shape, generator=gen,
                              device="cuda").to(torch.int8)
    else:
        pages = randn(shape, torch.bfloat16, gen)
    k_new = randn((batch, hkv, d), torch.bfloat16, gen)
    v_new = randn((batch, hkv, d), torch.bfloat16, gen)
    ids = torch.randperm(num_pages, generator=gen, device="cuda")[:batch]
    rows = torch.randint(0, ps, (batch,), generator=gen, device="cuda")
    return pages, k_new, v_new, ids.to(torch.int32), rows.to(torch.int32)


def check_append(name, fmt, ps, gen, *, iters=20):
    """The append kernel vs its plain version (the scatter decomposition),
    bit for bit; device times of both. The bound: the new rows read once,
    the page rows and scale bytes written once."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, page_append_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    pages, k_new, v_new, ids, rows = append_inputs(gen, fmt=fmt, ps=ps)
    want = page_append_plain(pages.clone(), k_new, v_new, ids, rows,
                             page_size=ps)
    got = fused_page_append(pages, k_new, v_new, ids, rows, page_size=ps)
    torch.cuda.synchronize()
    ok = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    err = max_err(got, want)
    t_kernel = cuda_time_ms(lambda: fused_page_append(
        pages, k_new, v_new, ids, rows, page_size=ps), iters=iters)[
        "median_ms"]
    t_plain = cuda_time_ms(lambda: page_append_plain(
        pages, k_new, v_new, ids, rows, page_size=ps), iters=iters)[
        "median_ms"]
    h_kernel = host_us(lambda: fused_page_append(
        pages, k_new, v_new, ids, rows, page_size=ps))
    h_plain = host_us(lambda: page_append_plain(
        pages, k_new, v_new, ids, rows, page_size=ps))
    batch, hkv, d = k_new.shape
    row_bytes = d * pages.element_size() + (4 if fmt == "int8" else 0)
    nbytes = (2 * k_new.numel() * k_new.element_size() + 8 * batch
              + 2 * batch * hkv * row_bytes)
    bound_ms, bound_by = _bound(0.0, nbytes, torch.bfloat16)
    log(f"page append {name}: {fmt} pages{tuple(pages.shape)} ps {ps}, "
        f"{batch} tokens x {hkv} kv heads | bit-exact vs plain: {ok} | "
        f"kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms bound "
        f"{bound_ms:.6f} ms ({bound_by}) | host {h_kernel:.1f} us a call, "
        f"plain {h_plain:.1f} us | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"append kernel disagrees with plain: {name}")
    return {"max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


# --- phase 4: flash backward, kernels vs plain and the oracle ----------------

# (name, q shape, kv shape, dtype, causal, masks); the first two are the
# train step's per-layer shapes, the window 1024 row the swa train cell's;
# masks: "window", "mix" (segment ids of the jagged mix packed into one
# row, its page bucket), "starts" (with its static segment_starts)
BWD_CASES = [
    ("train step 4 x 2048 (tri regime)", (4, 8, 2048, 128), (4, 2, 2048, 128),
     torch.bfloat16, True, {}),
    ("train step 1 x 8192 (tri with head splits, banded regime)",
     (1, 8, 8192, 128), (1, 2, 8192, 128), torch.bfloat16, True, {}),
    ("causal 768 (fused work-list regime)", (2, 8, 768, 128),
     (2, 2, 768, 128), torch.bfloat16, True, {}),
    ("non-causal 1024", (2, 8, 1024, 128), (2, 2, 1024, 128),
     torch.bfloat16, False, {}),
    ("decode offset q128/kv2048", (2, 8, 128, 128), (2, 2, 2048, 128),
     torch.bfloat16, True, {}),
    ("empty rows q2048/kv128", (2, 8, 2048, 128), (2, 2, 128, 128),
     torch.bfloat16, True, {}),
    ("causal 1024 f32", (1, 8, 1024, 128), (1, 2, 1024, 128), torch.float32,
     True, {}),
    ("window 1024 (swa train step)", (1, 8, 8192, 128), (1, 2, 8192, 128),
     torch.bfloat16, True, {"window": 1024}),
    ("packed mix, ids and segment_starts", (1, 8, 9984, 128),
     (1, 2, 9984, 128), torch.bfloat16, True, {"mix": True, "starts": True}),
    ("packed mix, ids without segment_starts", (1, 8, 9984, 128),
     (1, 2, 9984, 128), torch.bfloat16, True, {"mix": True}),
    ("window 256 f32", (1, 8, 1024, 128), (1, 2, 1024, 128), torch.float32,
     True, {"window": 256}),
]


def _rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def check_bwd(name, q_shape, kv_shape, dtype, causal, masks, gen, *,
              iters=10):
    """The backward kernels vs their plain version and vs autograd through
    the f32 plain forward on one shape, with its masks; then the device
    times of the whole backward call, of each kernel alone (bf16: prep,
    main, post; f32: dq, dk/dv), of the plain version and of SDPA's
    backward (with a boolean mask where the masks are more than causal)."""
    from tiny_flash_attention_tpu_torch.models.engine import pack_prompts
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain, visible_mask)
    from tiny_flash_attention_tpu_torch.ops import flash_bwd as FB
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    q = randn(q_shape, dtype, gen)
    k, v = randn(kv_shape, dtype, gen), randn(kv_shape, dtype, gen)
    do = randn(q_shape, dtype, gen)
    sm_scale = 1.0 / q_shape[-1] ** 0.5
    mk, ids = {"window": masks.get("window")}, None
    if masks.get("mix"):
        _, ids, _, offs = pack_prompts([[0] * n for n in JAGGED_MIX], 128,
                                       "page")
        seg = torch.as_tensor(ids, device="cuda")
        mk["segment_ids"] = (seg, seg)
    kw = dict(mk, segment_starts=offs if masks.get("starts") else None)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True, **mk)
    got = FB.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, **kw)
    torch.cuda.synchronize()
    plain = FB.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, sm_scale=sm_scale,
                                         **mk)
    err_plain = [_rel_err(g, w) for g, w in zip(got, plain)]
    abs_err = max(max_err(g, w) for g, w in zip(got, plain))
    del plain
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_plain(*leaves, causal=causal, sm_scale=sm_scale,
                                **mk)
    oracle = torch.autograd.grad(ref, leaves, do.float())
    err_oracle = [_rel_err(g, w) for g, w in zip(got, oracle)]
    del ref, oracle, leaves
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    ok = (finite and max(err_plain) <= BWD_PLAIN_GATE[dtype]
          and max(err_oracle) <= BWD_ORACLE_GATE[dtype])

    call = FB.BwdLaunch(q, k, v, out, lse, do, causal=causal,
                        sm_scale=sm_scale, **kw)
    stages = ({"prep": 1, "main": 2, "post": 4} if dtype == torch.bfloat16
              else {"dq": 1, "dkv": 2})
    t_call = cuda_time_ms(lambda: FB.flash_attention_bwd(
        q, k, v, out, lse, do, causal=causal, **kw),
        iters=iters)["median_ms"]
    t_part = {part: cuda_time_ms(lambda s=s: call.run(s),
                                 iters=iters)["median_ms"]
              for part, s in stages.items()}
    del call
    t_plain = cuda_time_ms(lambda: FB.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal=causal, sm_scale=sm_scale, **mk),
        iters=2 if q_shape[2] >= 8192 else iters)["median_ms"]
    mask = None
    if causal and (q_shape[2] != kv_shape[2] or len(masks)):
        # SDPA's is_causal aligns the mask top-left; the port's is
        # bottom-right (row i sits at i + kv_len - q_len)
        mask = visible_mask(q_shape[2], kv_shape[2], "cuda", causal=True,
                            **mk)
    sq, sk, sv = (t.detach().requires_grad_() for t in (q, k, v))
    s_out = F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    t_sdpa = cuda_time_ms(lambda: torch.autograd.grad(
        s_out, (sq, sk, sv), do, retain_graph=True),
        iters=iters)["median_ms"]
    del s_out, mask
    pairs = mask_pairs(q, k, causal, masks.get("window"), ids)
    bounds = {part: bwd_bound(q, k, part, pairs)
              for part in ("all", *stages)}
    log(f"flash bwd {name}: q{tuple(q_shape)} kv{tuple(kv_shape)} "
        f"{str(dtype).split('.')[-1]} causal={causal} | dq/dk/dv err vs "
        f"plain {err_plain[0]:.2e}/{err_plain[1]:.2e}/{err_plain[2]:.2e} "
        f"(gate {BWD_PLAIN_GATE[dtype]:.0e}), vs f32 autograd "
        f"{err_oracle[0]:.2e}/{err_oracle[1]:.2e}/{err_oracle[2]:.2e} "
        f"(gate {BWD_ORACLE_GATE[dtype]:.0e}) of max |grad| | call "
        f"{t_call:.4f} ms ("
        + ", ".join(f"{p} {t:.4f}" for p, t in t_part.items())
        + f") plain {t_plain:.4f} ms sdpa bwd {t_sdpa:.4f} ms bound "
        f"{bounds['all'][0]:.4f} ms ({bounds['all'][1]}; "
        + ", ".join(f"{p} {bounds[p][0]:.4f}" for p in stages)
        + f") | {bounds['all'][0] / t_call:.1%} of the bound | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash backward kernels disagree: {name}")
    return {"max_abs_err": abs_err, "ms": t_part, "call_ms": t_call,
            "plain_ms": t_plain, "library_ms": t_sdpa, "bound": bounds}


# --- phase 5: the engine end to end ------------------------------------------


def engine_config():
    """The engine benchmark's model (benchmarks/engine_bench.py:34-36)."""
    from tiny_flash_attention_tpu_torch.models import transformer as T

    return T.ModelConfig(vocab_size=32768, d_model=1024, n_layers=4,
                         n_q_heads=8, n_kv_heads=2, d_head=128, d_ff=4096,
                         dtype=torch.bfloat16)


def engine_phase(gen_seed: int) -> dict:
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.models.engine import (
        InferenceEngine, Request)
    from tiny_flash_attention_tpu_torch.models.inference import (
        decode_step, prefill_forward_batched)
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)

    cfg = engine_config()
    max_seqs, pages_per_seq, ps = 8, 32, 128
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(gen_seed),
        device="cuda")
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"],
                                       params["final_norm"]]) + sum(
        t.numel() for layer in params["layers"] for t in layer.values())
    eng = InferenceEngine(cfg, params, num_pages=max_seqs * pages_per_seq + 8,
                          page_size=ps, max_seqs=max_seqs,
                          pages_per_seq=pages_per_seq, seed=gen_seed,
                          device="cuda")
    rng = np.random.default_rng(gen_seed)
    short = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in rng.integers(600, 761, 4)]
    long = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in rng.integers(1500, 2049, 4)]
    n_chunk, n_chunks, n_single = 32, 2, 3
    # none finishes: the profiled steps and the two timed chunks of main()
    # included
    max_new = (1 + n_chunk * n_chunks + n_single + 2 * PROFILE_STEPS
               + 2 * n_chunk + 8)
    reqs = [Request(p, max_new) for p in short + long]

    # ---- the main path: counts zeroed just before, read just after ----
    flash_attention.launches = 0
    fused_paged_decode_attention.launches = 0
    fused_page_append.launches = 0
    torch.cuda.synchronize()
    prefill_ms = []
    for batch in (reqs[:4], reqs[4:]):
        t0 = time.perf_counter()
        eng.add_requests(batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    snap = dict(pages=[p.clone() for p in eng.cache.pages],
                table=eng.cache.page_table.copy(),
                lengths=eng.cache.lengths.copy(),
                last=eng.last_token.copy())
    chunk_s = []
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        eng.steps(n_chunk)            # ends in a device-to-host copy
        chunk_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(n_single):
        eng.step()
    single_s = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "paged_decode": fused_paged_decode_attention.launches,
                "page_append": fused_page_append.launches}
    # ---------------------------------------------------------------------

    n_steps = n_chunk * n_chunks + n_single
    want = {"flash_fwd": 2 * cfg.n_layers,
            "paged_decode": n_steps * cfg.n_layers,
            "page_append": n_steps * cfg.n_layers}
    log(f"engine: {n_params / 1e6:.1f} M params; prompts "
        f"{[len(p) for p in short + long]}; launches {launches} "
        f"(expected {want})")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for r in reqs:
        assert len(r.generated) == 1 + n_steps, len(r.generated)
        assert all(0 <= t < cfg.vocab_size for t in r.generated)

    # prefill: the engine's kernel path against the plain attention path
    L = max(len(p) for p in long)
    toks = torch.zeros((4, -(-L // ps) * ps), dtype=torch.int32,
                       device="cuda")
    for i, p in enumerate(long):
        toks[i, :len(p)] = torch.tensor(p, device="cuda")
    last = torch.tensor([len(p) - 1 for p in long], device="cuda")
    rows = torch.arange(4, device="cuda")
    got = prefill_forward_batched(cfg, params, toks)[0][rows, last]
    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    ref = prefill_forward_batched(plain_cfg, params, toks)[0][rows, last]
    scale = float(ref.abs().max())
    err = max_err(got, ref)
    # bf16 activations round at every projection of 4 layers, so two
    # attention paths that round differently differ by a little under 1 %
    # of the largest logit (the fp32 model agrees to 2e-5 in
    # tests/test_torch_model.py)
    gate = ENGINE_LOGIT_GATE * scale
    first = [r.generated[0] for r in reqs[4:]]
    log(f"engine prefill logits vs plain attention: max err {err:.4f} "
        f"(gate {gate:.4f} = {ENGINE_LOGIT_GATE:.1%} of max |logit| "
        f"{scale:.3f}); first tokens "
        f"{first} vs argmax {got.argmax(-1).tolist()}")
    if err > gate or not torch.isfinite(got).all():
        raise AssertionError("engine prefill logits disagree with plain")
    if first != got.argmax(-1).tolist():
        raise AssertionError("engine first tokens are not the argmax of "
                             "its prefill logits")

    # decode: the first decode step against a prefill of prompt + token
    dec, _ = decode_step(
        cfg, params, snap["pages"], torch.as_tensor(snap["last"],
                                                    device="cuda"),
        torch.as_tensor(snap["lengths"], device="cuda"),
        torch.as_tensor(snap["table"], device="cuda"), page_size=ps,
        fmt="bf16")
    seqs = [r.prompt + [r.generated[0]] for r in reqs]
    full = torch.zeros((len(seqs), max(map(len, seqs))), dtype=torch.int32,
                       device="cuda")
    for i, s in enumerate(seqs):
        full[i, :len(s)] = torch.tensor(s, device="cuda")
    pre = prefill_forward_batched(cfg, params, full)[0]
    slots = [r.slot for r in reqs]
    want_logits = pre[torch.arange(len(seqs), device="cuda"),
                      torch.tensor([len(s) - 1 for s in seqs],
                                   device="cuda")]
    got_logits = dec[torch.tensor(slots, device="cuda")]
    scale = float(want_logits.abs().max())
    err = max_err(got_logits, want_logits)
    gate = ENGINE_LOGIT_GATE * scale
    second = [r.generated[1] for r in reqs]
    log(f"engine first decode step vs prefill of prompt + token: max err "
        f"{err:.4f} (gate {gate:.4f}); second tokens {second} vs decode "
        f"argmax {got_logits.argmax(-1).tolist()}")
    if err > gate or not torch.isfinite(got_logits).all():
        raise AssertionError("decode logits disagree with prefill")
    if second != got_logits.argmax(-1).tolist():
        raise AssertionError("engine second tokens are not the argmax of "
                             "its first decode step")

    steady = chunk_s[-1]
    tok_s = max_seqs * n_chunk / steady
    log(f"engine timing: prefill {prefill_ms[0]:.2f} ms (4 x L_pad 768), "
        f"{prefill_ms[1]:.2f} ms (4 x L_pad 2048); decode steps({n_chunk}) "
        f"{[round(s * 1e3, 2) for s in chunk_s]} ms -> {tok_s:.0f} tokens/s "
        f"(8 slots, last chunk); step() "
        f"{single_s / n_single * 1e3:.2f} ms/token-step")
    return {"launches": launches, "engine": eng, "cfg": cfg,
            "long_tokens": toks, "n_chunk": n_chunk}


# --- phase 5b: quantized serving ---------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the serving and encoder paths swapped for its plain
    version (the flash forward in the prefills and the encoder, the
    row-loop forward, the decode attention, the append and the quantized
    matmul), for holding the paths' outputs against them on the card."""
    from tiny_flash_attention_tpu_torch.models import encoder as E
    from tiny_flash_attention_tpu_torch.models import inference as I
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops import flash as FL
    from tiny_flash_attention_tpu_torch.ops import flash_rowloop as RL
    from tiny_flash_attention_tpu_torch.ops import paged_fused as PF
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops import quant_matmul as QM

    def decode_plain(q, pages, lengths, table, *, page_size, window=None):
        return PF.fused_paged_decode_plain(q, pages, lengths, table,
                                           page_size=page_size,
                                           sm_scale=q.shape[-1] ** -0.5,
                                           window=window)

    def flash_plain(q, k, v, *, causal=False, segment_ids=None,
                    segment_starts=None, window=None):
        return FL.flash_attention_plain(q, k, v, causal=causal,
                                        sm_scale=q.shape[-1] ** -0.5,
                                        segment_ids=segment_ids,
                                        window=window)

    def rowloop_plain(q, k, v, *, causal=False, seq_lengths=None):
        return RL.flash_attention_rowloop_plain(
            q, k, v, causal=causal, sm_scale=q.shape[-1] ** -0.5,
            seq_lengths=seq_lengths)

    patches = [(I, "fused_paged_decode_attention", decode_plain),
               (I, "fused_page_append", PF.page_append_plain),
               (Q, "quantized_matmul_cuda", QM.quantized_matmul_plain),
               (T, "flash_attention", flash_plain),
               (I, "flash_attention", flash_plain),
               (E, "flash_attention", flash_plain),
               (I, "flash_attention_rowloop", rowloop_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# (label, int8 weights, prompt length, pages per slot): the int8-KV runs of
# benchmarks/engine_bench.py:190-191 (prompt 512) and :217-218 (7936)
QUANT_RUNS = [("int8 KV, bf16 weights, prompt 512", False, 512, 32),
              ("int8 KV, int8 weights, prompt 512", True, 512, 32),
              ("int8 KV, bf16 weights, prompt 7936", False, 7936, 64),
              ("int8 KV, int8 weights, prompt 7936", True, 7936, 64)]


def quant_engine_run(cfg, params, label, quantized, prompt_len,
                     pages_per_seq, seed) -> dict:
    """One int8-KV engine: 8 prompts admitted one by one (as
    engine_bench.py does), two steps(32) chunks, the launch counts zeroed
    just before the admissions and read just after the chunks; then the
    first decode step against its plain versions and a profile."""
    from tiny_flash_attention_tpu_torch.models.engine import (
        InferenceEngine, Request)
    from tiny_flash_attention_tpu_torch.models.inference import decode_step
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)
    from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
        quantized_matmul_cuda)

    max_seqs, ps, n_chunk, n_chunks = 8, 128, 32, 2
    eng = InferenceEngine(cfg, params, num_pages=max_seqs * pages_per_seq + 8,
                          page_size=ps, max_seqs=max_seqs,
                          pages_per_seq=pages_per_seq, kv_format="int8",
                          seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    max_new = 1 + n_chunk * n_chunks + PROFILE_STEPS + 8
    reqs = [Request(rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                    max_new) for _ in range(max_seqs)]
    counters = {"flash_fwd": flash_attention,
                "paged_decode": fused_paged_decode_attention,
                "page_append": fused_page_append,
                "quant_matmul": quantized_matmul_cuda}

    # ---- the main path: counts zeroed just before, read just after ----
    for fn in counters.values():
        fn.launches = 0
    fused_paged_decode_attention.int8_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.add_request(r)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    snap = dict(pages=[p.clone() for p in eng.cache.pages],
                table=eng.cache.page_table.copy(),
                lengths=eng.cache.lengths.copy(),
                last=eng.last_token.copy())
    chunk_s = []
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        eng.steps(n_chunk)            # ends in a device-to-host copy
        chunk_s.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["paged_decode_int8"] = fused_paged_decode_attention.int8_launches
    # ---------------------------------------------------------------------

    steps, L = n_chunk * n_chunks, cfg.n_layers
    want = {"flash_fwd": max_seqs * L, "paged_decode": 0,
            "page_append": steps * L,
            "quant_matmul": steps * (7 * L + 1) if quantized else 0,
            "paged_decode_int8": steps * L}
    log(f"quantized engine [{label}]: launches {launches} (expected {want}:"
        f" per decode step {L} appends and int8 decodes"
        + (f", {7 * L + 1} quantized matmuls" if quantized else "") + ")")
    if launches != want:
        raise AssertionError(f"quantized engine launches {launches} != "
                             f"{want}")
    for r in reqs:
        assert len(r.generated) == 1 + steps, len(r.generated)
        assert all(0 <= t < cfg.vocab_size for t in r.generated)

    # the first decode step: the kernels against their plain versions on
    # the card, from the pages as admission left them
    def first_step():
        dec, _ = decode_step(
            cfg, params, [p.clone() for p in snap["pages"]],
            torch.as_tensor(snap["last"], device="cuda"),
            torch.as_tensor(snap["lengths"], device="cuda"),
            torch.as_tensor(snap["table"], device="cuda"), page_size=ps,
            fmt="int8")
        return dec

    got = first_step()
    with plain_kernels():
        ref = first_step()
    scale = float(ref.abs().max())
    err = max_err(got, ref)
    gate = ENGINE_LOGIT_GATE * scale
    second = [r.generated[1] for r in reqs]
    argmax = got.argmax(-1).tolist()
    log(f"quantized engine [{label}]: first decode step vs plain versions: "
        f"max err {err:.4f} (gate {gate:.4f} = {ENGINE_LOGIT_GATE:.1%} of "
        f"max |logit| {scale:.3f}); second tokens {second} vs argmax "
        f"{argmax}")
    if err > gate or not torch.isfinite(got).all():
        raise AssertionError(f"quantized decode logits disagree: {label}")
    if second != argmax:
        raise AssertionError(f"second tokens are not the argmax: {label}")
    tok_s = max_seqs * n_chunk / chunk_s[-1]
    log(f"quantized engine [{label}] timing: admission of {max_seqs} x "
        f"{prompt_len} tokens {prefill_ms:.1f} ms; decode steps({n_chunk}) "
        f"{[round(x * 1e3, 2) for x in chunk_s]} ms -> {tok_s:.0f} tokens/s"
        f" (8 slots, last chunk)")
    profile_window(f"per int8 decode step ({label}, steps({PROFILE_STEPS}))",
                   lambda: eng.steps(PROFILE_STEPS), PROFILE_STEPS)
    return {"launches": launches, "engine": eng}


def quant_serving_phase(seed) -> dict:
    from tiny_flash_attention_tpu_torch.models import transformer as T

    cfg = engine_config()
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    qparams = T.quantize_params(params, "int8")
    totals: dict = {}
    engines = {}
    for label, quantized, prompt_len, pps in QUANT_RUNS:
        run = quant_engine_run(cfg, qparams if quantized else params, label,
                               quantized, prompt_len, pps, seed)
        for k, n in run["launches"].items():
            totals[k] = totals.get(k, 0) + n
        engines[(quantized, prompt_len)] = run["engine"]
        del run
    return {"launches": totals, "engines": engines, "cfg": cfg}


# --- phase 5c: ragged admission and the encoder -------------------------------

# the heterogeneous mix of benchmarks/jagged_prefill_bench.py:41
JAGGED_MIX = [3968, 1024, 512, 384, 2048, 640, 256, 1152]
# (name, q shape (q_len == kv_len), segment bounds, dtype, causal): odd
# shapes, bounds off the 64-row tiles
SEG_CASES = [
    ("bf16 causal, 5 segments", (2, 8, 700, 128), (37, 300, 301, 650),
     torch.bfloat16, True),
    ("bf16 non-causal, 3 segments", (2, 8, 333, 128), (100, 200),
     torch.bfloat16, False),
    ("f32 causal, 3 segments", (1, 8, 257, 128), (64, 129), torch.float32,
     True),
    ("f32 non-causal, head_dim 64", (1, 4, 190, 64), (1,), torch.float32,
     False),
]


def segment_ids(b: int, n: int, bounds) -> torch.Tensor:
    ids = torch.zeros((b, n), dtype=torch.int32, device="cuda")
    for x in bounds:
        ids[:, x:] += 1
    return ids


def check_segments(name, q_shape, bounds, dtype, causal, gen) -> float:
    """B1 with segment ids against its plain version at an odd shape, a q
    row whose id matches no kv column included; then with segment_starts,
    which must not change a bit."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    b, hq, n, d = q_shape
    q = randn(q_shape, dtype, gen)
    k, v = (randn((b, 2, n, d), dtype, gen) for _ in range(2))
    seg = segment_ids(b, n, bounds)
    q_seg = seg.clone()
    q_seg[-1, n // 2] = 99                   # matches no kv column
    out, lse = flash_attention(q, k, v, causal=causal,
                               segment_ids=(q_seg, seg), return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=d ** -0.5,
                                         segment_ids=(q_seg, seg),
                                         return_lse=True)
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    empty = bool((out[-1, :, n // 2] == 0).all())
    pruned = flash_attention(q, k, v, causal=causal, segment_ids=(seg, seg),
                             segment_starts=(0, *bounds), return_lse=True)
    full = flash_attention(q, k, v, causal=causal, segment_ids=(seg, seg),
                           return_lse=True)
    same = all(torch.equal(x, y) for x, y in zip(pruned, full))
    atol = tolerance_for(dtype)
    ok = err <= atol and lse_err <= atol and empty and same
    log(f"flash segments {name}: q{tuple(q_shape)} bounds {bounds} causal="
        f"{causal} | out err {err:.3e} lse err {lse_err:.3e} (gate "
        f"{atol:.0e}) | unmatched row empty: {empty} | segment_starts "
        f"bit-equal to none: {same} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"segment kernel disagrees: {name}")
    return max(err, lse_err)


def check_rows(name, out, lse, ref, ref_lse, lens, atol) -> float:
    """Rows below each length within the gate (out and LSE), rows at or
    past it exactly 0 with the plain version's sentinel LSE."""
    err = 0.0
    for bi, L in enumerate(lens):
        err = max(err, max_err(out[bi, :, :L], ref[bi, :, :L]),
                  max_err(lse[bi, :, :L], ref_lse[bi, :, :L]))
        past_ok = (bool((out[bi, :, L:] == 0).all())
                   and torch.allclose(lse[bi, :, L:], ref_lse[bi, :, L:],
                                      rtol=1e-6, atol=0.0))
        if not past_ok:
            raise AssertionError(f"{name}: row {bi} past its length {L} is "
                                 "not an empty row")
    if not err <= atol:
        raise AssertionError(f"{name}: err {err:.3e} > {atol:.0e}")
    return err


def check_rowloop(gen) -> float:
    """B11 against its plain version: jagged lengths around one tile and
    the whole row, bf16 and f32; then without lengths, non-causal and with
    a decode offset."""
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop, flash_attention_rowloop_plain)
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    n = 1024
    lens = [1, 63, 64, 65, n]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q = randn((5, 8, n, 128), dtype, gen)
        k, v = (randn((5, 2, n, 128), dtype, gen) for _ in range(2))
        atol = tolerance_for(dtype)
        cases = [("jagged", q, True, lens), ("non-causal", q, False, None),
                 ("decode offset q128", q[:, :, -128:], True, None)]
        for label, qq, causal, ln in cases:
            lt = None if ln is None else torch.tensor(ln, device="cuda")
            out, lse = flash_attention_rowloop(qq, k, v, causal=causal,
                                               seq_lengths=lt)
            torch.cuda.synchronize()
            ref, ref_lse = flash_attention_rowloop_plain(
                qq, k, v, causal=causal, sm_scale=128 ** -0.5,
                seq_lengths=lt)
            err = check_rows(f"rowloop {label}", out, lse, ref, ref_lse,
                             ln or [qq.shape[2]] * 5, atol)
            worst = max(worst, err)
            log(f"rowloop {label} {str(dtype).split('.')[-1]}: q"
                f"{tuple(qq.shape)} kv{tuple(k.shape)} lengths {ln} | err "
                f"{err:.3e} (gate {atol:.0e}) on rows below each length; "
                f"rows past it 0 with the sentinel LSE | ok")
    return worst


def sdpa_kernel_name(fn) -> str:
    """The device kernel that took most of one call's time: which backend
    SDPA dispatched to."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "not measured"
    return max(kernels, key=lambda e: e.self_device_time_total).key[:80]


def time_masked(name, q, k, v, *, kernel, plain, sdpa_mask, sdpa_causal,
                bound, valid_lens=None, iters=5) -> dict:
    """One slice kernel at a main-path shape: against its plain version
    (on rows below `valid_lens` where given), then the device times of the
    kernel, the plain version and SDPA with a boolean mask (the library
    yardstick, which the port never calls)."""
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    out, lse = kernel()
    torch.cuda.synchronize()
    ref, ref_lse = plain()
    lens = valid_lens or [q.shape[2]] * q.shape[0]
    err = check_rows(name, out, lse, ref, ref_lse, lens,
                     tolerance_for(q.dtype))
    del out, lse, ref, ref_lse
    t_kernel = cuda_time_ms(kernel, iters=iters)["median_ms"]
    t_plain = cuda_time_ms(plain, iters=2)["median_ms"]

    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, is_causal=sdpa_causal,
            enable_gqa=True)
    t_sdpa = cuda_time_ms(sdpa, iters=iters)["median_ms"]
    backend = sdpa_kernel_name(sdpa)
    bound_ms, bound_by = bound
    log(f"{name}: q{tuple(q.shape)} kv{tuple(k.shape)} | err {err:.3e} | "
        f"kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms sdpa "
        f"{t_sdpa:.4f} ms ({backend}) bound {bound_ms:.4f} ms ({bound_by}) "
        f"| {bound_ms / t_kernel:.1%} of the bound | ok")
    return {"max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
            "library_ms": t_sdpa, "bound_ms": bound_ms, "bound_by": bound_by}


def time_ragged_kernels(gen, seed: int) -> dict:
    """B1 and B11 at the slice's main-path shapes: the packed row of the
    jagged mix with and without segment_starts, the encoder's 8 x 2048
    batch with pad ids, the jagged batch of the mix and, for comparison,
    B1 on the same batch padded."""
    from tiny_flash_attention_tpu_torch.models.engine import pack_prompts
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain, segment_tiles)
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop, flash_attention_rowloop_plain)

    sc = 128 ** -0.5
    rows = {}
    # packed: one row of 9984 tokens, the page bucket's segments
    _, segs, _, offs = pack_prompts([[0] * n for n in JAGGED_MIX], 128,
                                    "page")
    n = segs.shape[1]
    q = randn((1, 8, n, 128), torch.bfloat16, gen)
    k, v = (randn((1, 2, n, 128), torch.bfloat16, gen) for _ in range(2))
    seg = torch.as_tensor(segs, device="cuda")
    tiles = segment_tiles(offs, n, causal=True, dtype=torch.bfloat16,
                          device="cuda")
    same = seg[0][:, None] == seg[0][None, :]
    mask = (same & torch.ones_like(same).tril())[None, None]
    bound = ragged_bound(q, k, id_pairs(segs, True), int_bytes=2 * n * 4)
    for label, starts in (("with", tiles), ("without", None)):
        rows[f"packed {label}"] = time_masked(
            f"B1 packed row of the mix, {label} segment_starts", q, k, v,
            kernel=lambda st=starts: flash_attention(
                q, k, v, causal=True, segment_ids=(seg, seg),
                segment_starts=st, return_lse=True),
            plain=lambda: flash_attention_plain(
                q, k, v, causal=True, sm_scale=sc, segment_ids=(seg, seg),
                return_lse=True),
            sdpa_mask=mask, sdpa_causal=False, bound=bound)
    pruned = flash_attention(q, k, v, causal=True, segment_ids=(seg, seg),
                             segment_starts=tiles)
    if not torch.equal(pruned, flash_attention(q, k, v, causal=True,
                                               segment_ids=(seg, seg))):
        raise AssertionError("segment_starts changed the packed output")
    del q, k, v, mask, same, pruned

    # encoder: 8 x 2048, pad ids (valid 1, pad 2), non-causal
    rng = np.random.default_rng(seed)
    lens = rng.integers(1024, 2049, 8)
    ids = np.where(np.arange(2048)[None, :] < lens[:, None], 1, 2).astype(
        np.int32)
    q = randn((8, 8, 2048, 128), torch.bfloat16, gen)
    k, v = (randn((8, 2, 2048, 128), torch.bfloat16, gen) for _ in range(2))
    eseg = torch.as_tensor(ids, device="cuda")
    rows["encoder"] = time_masked(
        "B1 encoder batch 8 x 2048, pad ids", q, k, v,
        kernel=lambda: flash_attention(q, k, v, segment_ids=(eseg, eseg),
                                       return_lse=True),
        plain=lambda: flash_attention_plain(
            q, k, v, causal=False, sm_scale=sc, segment_ids=(eseg, eseg),
            return_lse=True),
        sdpa_mask=(eseg[:, :, None] == eseg[:, None, :])[:, None],
        sdpa_causal=False,
        bound=ragged_bound(q, k, id_pairs(ids, False),
                           int_bytes=2 * ids.size * 4))
    del q, k, v

    # the jagged batch of the mix (L_pad 4096), and B1 on it padded
    L_pad = 4096
    q = randn((8, 8, L_pad, 128), torch.bfloat16, gen)
    k, v = (randn((8, 2, L_pad, 128), torch.bfloat16, gen) for _ in range(2))
    lt = torch.tensor(JAGGED_MIX, dtype=torch.int32, device="cuda")
    pos = torch.arange(L_pad, device="cuda")
    valid = pos[None, :] < lt[:, None]
    jmask = ((pos[None, :, None] >= pos[None, None, :])
             & valid[:, None, :])[:, None]
    pairs = float(sum(L * (L + 1) / 2 for L in JAGGED_MIX))
    rows["jagged"] = time_masked(
        "B11 jagged batch of the mix", q, k, v,
        kernel=lambda: flash_attention_rowloop(q, k, v, causal=True,
                                               seq_lengths=lt),
        plain=lambda: flash_attention_rowloop_plain(
            q, k, v, causal=True, sm_scale=sc, seq_lengths=lt),
        sdpa_mask=jmask, sdpa_causal=False, valid_lens=JAGGED_MIX,
        bound=ragged_bound(q, k, pairs, tokens=sum(JAGGED_MIX),
                           int_bytes=8 * 4))
    del jmask
    rows["padded"] = time_masked(
        "B1 the mix padded to 8 x 4096", q, k, v,
        kernel=lambda: flash_attention(q, k, v, causal=True,
                                       return_lse=True),
        plain=lambda: flash_attention_plain(q, k, v, causal=True,
                                            sm_scale=sc, return_lse=True),
        sdpa_mask=None, sdpa_causal=True, bound=flash_bound(q, k, True))
    log(f"B11 at the mix {rows['jagged']['ms']:.4f} ms against B1 on the "
        f"padded batch {rows['padded']['ms']:.4f} ms: "
        f"{rows['padded']['ms'] / rows['jagged']['ms']:.2f}x (bounds "
        f"{rows['jagged']['bound_ms']:.4f} and "
        f"{rows['padded']['bound_ms']:.4f} ms)")
    return rows


# (label, admit(engine, requests), kernel counted per admission)
ADMISSIONS = [
    ("batched", lambda e, r: e.add_requests(r), "flash_fwd"),
    ("packed page", lambda e, r: e.add_requests_packed(r, "page"),
     "flash_fwd"),
    ("packed pow2", lambda e, r: e.add_requests_packed(r, "pow2"),
     "flash_fwd"),
    ("jagged", lambda e, r: e.add_requests_jagged(r), "flash_rowloop"),
]


def admission_logits(label, cfg, params, prompts, ps):
    """The prefill an admission mode runs, on the same inputs, at each
    request's last prompt row: (B, V) f32."""
    from tiny_flash_attention_tpu_torch.models import inference as I
    from tiny_flash_attention_tpu_torch.models.engine import (
        pack_prompts, pad_prompts)

    def dev(a):
        return torch.as_tensor(a, device="cuda")

    last = [len(p) - 1 for p in prompts]
    rows = torch.arange(len(prompts), device="cuda")
    if label.startswith("packed"):
        toks, segs, pos, offs = pack_prompts(prompts, ps, label.split()[1])
        logits = I.prefill_forward_packed(
            cfg, params, dev(toks), dev(segs), dev(pos),
            segment_starts=tuple(offs))[0]
        return logits[0, dev([o + x for o, x in zip(offs, last)])]
    toks = dev(pad_prompts(prompts, ps))
    if label == "jagged":
        logits = I.prefill_forward_jagged(
            cfg, params, toks, dev(np.asarray([len(p) for p in prompts],
                                              np.int32)))[0]
    else:
        logits = I.prefill_forward_batched(cfg, params, toks)[0]
    return logits[rows, dev(last)]


def ragged_admission_phase(seed: int) -> dict:
    """The jagged mix admitted into four fresh engines (batched, packed
    with page and pow2 buckets, jagged), then steps(32): launch counts per
    admission and decode step, each mode's prefill logits against the same
    prefill with every kernel swapped for its plain version, first tokens
    against their argmax, the modes' greedy agreement, and the admission
    time (median of 3 after a warm-up)."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.models.engine import (
        InferenceEngine, Request)
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)

    cfg = engine_config()
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in JAGGED_MIX]
    ps, n_chunk = 128, 32
    counters = {"flash_fwd": flash_attention,
                "flash_rowloop": flash_attention_rowloop,
                "paged_decode": fused_paged_decode_attention,
                "page_append": fused_page_append}

    def engine():
        return InferenceEngine(cfg, params, num_pages=512, page_size=ps,
                               max_seqs=8, pages_per_seq=32, seed=seed,
                               device="cuda")

    def requests():
        return [Request(list(p), 64) for p in prompts]

    totals = {k: 0 for k in counters}
    tokens, admit_ms = {}, {}
    for label, admit, kernel in ADMISSIONS:
        eng, reqs = engine(), requests()
        # ---- the main path: counts zeroed just before, read just after --
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        admit(eng, reqs)
        eng.steps(n_chunk)            # ends in a device-to-host copy
        launches = {k: fn.launches for k, fn in counters.items()}
        # -----------------------------------------------------------------
        want = {k: 0 for k in counters}
        want[kernel] = cfg.n_layers
        want["paged_decode"] = want["page_append"] = n_chunk * cfg.n_layers
        log(f"ragged admission [{label}]: launches {launches} (expected "
            f"{want})")
        if launches != want:
            raise AssertionError(f"{label} admission launches {launches} "
                                 f"!= {want}")
        for k in totals:
            totals[k] += launches[k]
        tokens[label] = [r.generated for r in reqs]
        assert all(len(g) == 1 + n_chunk for g in tokens[label])
        del eng

        got = admission_logits(label, cfg, params, prompts, ps)
        with plain_kernels():
            ref = admission_logits(label, cfg, params, prompts, ps)
        scale = float(ref.abs().max())
        err = max_err(got, ref)
        first = [g[0] for g in tokens[label]]
        argmax = got.argmax(-1).tolist()
        log(f"ragged admission [{label}]: last-row logits vs plain kernels "
            f"max err {err:.4f} (gate {ENGINE_LOGIT_GATE * scale:.4f} = "
            f"{ENGINE_LOGIT_GATE:.1%} of max |logit| {scale:.3f}); first "
            f"tokens {first} vs argmax {argmax}")
        if err > ENGINE_LOGIT_GATE * scale or not torch.isfinite(got).all():
            raise AssertionError(f"{label} admission logits disagree")
        if first != argmax:
            raise AssertionError(f"{label} first tokens are not the argmax")
        del got, ref
        torch.cuda.empty_cache()
        profile_window(f"prefill of the mix, {label} admission",
                       lambda: admission_logits(label, cfg, params, prompts,
                                                ps), 1)

        times = []
        for _ in range(4):            # a warm-up, then 3 timed
            eng, reqs = engine(), requests()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            admit(eng, reqs)          # ends in a device-to-host copy
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del eng
        admit_ms[label] = float(np.median(times[1:]))

    base = np.asarray(tokens["batched"])
    agree = {label: float((np.asarray(t) == base).mean())
             for label, t in tokens.items()}
    log("ragged admission of the mix " + str(JAGGED_MIX) + ": prefill ms "
        "(median of 3, host clock) " + "; ".join(
            f"{k} {v:.2f}" for k, v in admit_ms.items())
        + " | greedy tokens equal to batched's: " + "; ".join(
            f"{k} {v:.1%}" for k, v in agree.items()))
    return {"launches": totals, "admit_ms": admit_ms}


def encoder_phase(seed: int) -> dict:
    """embed_texts of the encoder benchmark's two shapes (benchmarks/
    encoder_bench.py:20-29,53): launch counts, embeddings against the plain
    path, pad invariance, tokens/s (median of 3 after a warm-up)."""
    from tiny_flash_attention_tpu_torch.models import encoder as E
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention

    cfg = engine_config()
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    rng = np.random.default_rng(seed)
    launches = 0
    for batch, seq in ((8, 2048), (32, 512)):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (batch, seq)), device="cuda")
        lengths = torch.as_tensor(rng.integers(seq // 2, seq + 1, batch),
                                  device="cuda")
        # ---- the main path: counts zeroed just before, read just after --
        flash_attention.launches = 0
        emb = E.embed_texts(cfg, params, tokens, lengths)
        torch.cuda.synchronize()
        got = flash_attention.launches
        # -----------------------------------------------------------------
        if got != cfg.n_layers:
            raise AssertionError(f"encoder launches {got} != "
                                 f"{cfg.n_layers}")
        launches += got
        with plain_kernels():
            ref = E.embed_texts(cfg, params, tokens, lengths)
        gate = ENGINE_LOGIT_GATE * float(ref.abs().max())
        err = max_err(emb, ref)
        # pad invariance: row 0's text with 256 more pad tokens
        L0 = int(lengths[0])
        longer = torch.cat([tokens[:1], torch.full(
            (1, 256), 7, device="cuda", dtype=tokens.dtype)], dim=1)
        longer[0, L0:] = 13
        pad_err = max_err(E.embed_texts(cfg, params, longer, lengths[:1]),
                          emb[:1])
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            E.embed_texts(cfg, params, tokens, lengths)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        tok_s = batch * seq / float(np.median(times[1:]))
        ok = (err <= gate and pad_err <= gate
              and bool(torch.isfinite(emb).all()))
        log(f"encoder embed_texts {batch} x {seq} (lengths "
            f"{int(lengths.min())}-{int(lengths.max())}): launches {got} | "
            f"vs plain kernels max err {err:.3e}, pad invariance (+256 pad) "
            f"{pad_err:.3e} (gate {gate:.3e} = {ENGINE_LOGIT_GATE:.1%} of max "
            f"|value|) | {tok_s:.0f} tokens/s (median of 3) | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("encoder embeddings disagree")
    return {"launches": launches}


# --- phase 6: training at full width -----------------------------------------

# (batch, seq, timed steps, window): benchmarks/train_bench.py's two
# configs, then the swa train cell: the model with the sliding window of
# swa_serving (1024) at 1 x 8192, whose backward takes the window
TRAIN_CONFIGS = [(4, 2048, 8, None), (1, 8192, 3, None), (1, 8192, 3, 1024)]
# the f32 train step (ModelConfig dtype float32): its backward runs the f32
# kernels at the shape of BWD_CASES' "causal 1024 f32" row, whose times
# and bound the f32 kernels' JSON rows report; (batch, seq, steps)
TRAIN_F32 = (1, 1024, 2)


def train_grad_check(cfg, params, tokens) -> float:
    """One step's gradients through the kernels against those through
    attn_impl="reference" (plain attention), per parameter; returns the
    largest relative Frobenius distance."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.parallel.train import param_leaves

    def leaf(t):
        return t.detach().requires_grad_()

    def grads(run_cfg):
        copy = {"embed": leaf(params["embed"]),
                "layers": [{name: leaf(t) for name, t in layer.items()}
                           for layer in params["layers"]],
                "final_norm": leaf(params["final_norm"]),
                "lm_head": leaf(params["lm_head"])}
        return torch.autograd.grad(T.loss_fn(run_cfg, copy, tokens),
                                   param_leaves(copy))

    got = grads(cfg)
    want = grads(dataclasses.replace(cfg, attn_impl="reference"))
    return max(float((g.float() - w.float()).norm() / w.float().norm())
               for g, w in zip(got, want))


def train_phase(seed: int) -> dict:
    """The train step of parallel/train.py at the train benchmark's widths
    and in the swa train cell: one warm-up and the timed steps per config
    on one fixed token batch, the launch counts zeroed just before the
    timed steps and read just after; then the f32 train step."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd)
    from tiny_flash_attention_tpu_torch.parallel.train import make_train_step

    cfg = T.ModelConfig(vocab_size=32768, d_model=1024, n_layers=4,
                        n_q_heads=8, n_kv_heads=2, d_head=128, d_ff=4096,
                        dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params0 = T.init_params(cfg, gen, device="cuda")
    launches = {"flash_fwd": 0, "flash_bwd": 0}
    out = {"states": {}}
    for batch, seq, n_timed, window in TRAIN_CONFIGS:
        run_cfg = dataclasses.replace(cfg, attn_window=window)
        step, init_state = make_train_step(run_cfg, learning_rate=1e-3)
        params, opt = init_state(params0)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device="cuda")
        params, opt, loss0 = step(params, opt, tokens)        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: counts zeroed just before, read just after ----
        flash_attention.launches = 0
        flash_attention.window_launches = 0
        flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        losses = []
        for _ in range(n_timed):
            params, opt, loss = step(params, opt, tokens)
            losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {"flash_fwd": flash_attention.launches,
               "flash_fwd_window": flash_attention.window_launches,
               "flash_bwd": flash_attention_bwd.launches}
        # ---------------------------------------------------------------------

        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(x) for x in [loss0] + losses]
        want = n_timed * cfg.n_layers
        label = f"{batch} x {seq}" + (f" window {window} (swa train)"
                                      if window else "")
        log(f"train {label}: {n_timed} steps in {dt * 1e3:.1f} ms, "
            f"{dt / n_timed * 1e3:.2f} ms/step, "
            f"{batch * seq * n_timed / dt:.0f} tokens/s, peak memory "
            f"{peak:.2f} GiB; loss {' '.join(f'{x:.4f}' for x in losses)}; "
            f"launches {got} (expected {want} forward and {want} backward "
            f"calls: one each per layer per step, {cfg.n_layers} layers; "
            f"a backward call launches flash_bwd_prep, flash_bwd_main and "
            f"flash_bwd_post once each)")
        expect = {"flash_fwd": want, "flash_fwd_window": want if window
                  else 0, "flash_bwd": want}
        if got != expect:
            raise AssertionError(f"train launches {got} != {expect}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train loss not finite or not falling: "
                                 f"{losses}")
        for key in launches:
            launches[key] += got[key]
        out["states"][label] = (step, params, opt, tokens)
    out["launches"] = launches

    # the f32 train step: its backward runs the f32 dq and dk/dv kernels
    batch, seq, n_steps = TRAIN_F32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    step, init_state = make_train_step(cfg32, learning_rate=1e-3)
    params, opt = init_state(T.init_params(cfg32, gen, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    flash_attention_bwd.launches = 0
    losses = []
    for _ in range(n_steps):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    out["launches"]["flash_bwd_f32"] = flash_attention_bwd.launches
    shown = " ".join(f"{x:.4f}" for x in losses)
    log(f"train f32 {batch} x {seq}: loss {shown}; "
        f"{flash_attention_bwd.launches} backward calls (expected "
        f"{n_steps * cfg.n_layers}: the f32 dq and dk/dv kernels once each)")
    if flash_attention_bwd.launches != n_steps * cfg.n_layers or not (
            np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"f32 train step: launches "
                             f"{flash_attention_bwd.launches}, {losses}")
    del params, opt

    # gradients of one step (the initial weights, the 4 x 2048 batch)
    err = train_grad_check(cfg, params0, out["states"]["4 x 2048"][3])
    log(f"train step gradients through the kernels vs attn_impl='reference':"
        f" max relative Frobenius distance over parameters {err:.3e} "
        f"(gate {TRAIN_GRAD_GATE:.0e})")
    if not err <= TRAIN_GRAD_GATE:
        raise AssertionError("train gradients disagree with the plain path")
    return out


# --- phase 7: the last two kernels (B12, B14) and the window -----------------

# (name, q shape, kv shape, dtype, causal): FA1 at the headline shape made
# MHA (B14 has no GQA), f32, and a q tile no kv tile reaches
V1_CASES = [
    ("MHA causal 2048", (2, 8, 2048, 128), (2, 8, 2048, 128), torch.bfloat16,
     True),
    ("MHA non-causal 2048", (2, 8, 2048, 128), (2, 8, 2048, 128),
     torch.bfloat16, False),
    ("MHA causal 1024 f32", (2, 8, 1024, 128), (2, 8, 1024, 128),
     torch.float32, True),
    ("q_len 1024 > kv_len 512", (2, 8, 1024, 128), (2, 8, 512, 128),
     torch.bfloat16, True),
]
# (name, pages, lengths): the paged decode of the north-star's config 2
# (benchmarks/attention_bench.py:146-157: 8 sequences of 8192 tokens, 8/2
# heads of 128, page_size 128, 64 pages each, a random page permutation)
B12_CASES = [("config 2, bf16 pages", "bf16", [8192] * 8),
             ("config 2, int8 pages", "int8", [8192] * 8),
             ("config 2, bf16 pages, mixed short lengths", "bf16",
              [1, 127, 128, 129, 1000, 4096, 8000, 8192])]


def b12_inputs(gen, fmt, lengths, *, batch=8, hq=8, hkv=2, d=128, ps=128,
               P=64):
    """q, K and V page arrays (int8 QuantizedTensors made from bf16 pages by
    the port's quantizer), lengths and a random page table."""
    from tiny_flash_attention_tpu_torch.ops.quant import quantize_int8

    num_pages = batch * P + 7
    q = randn((batch, hq, d), torch.bfloat16, gen)
    k, v = (randn((hkv, num_pages, ps, d), torch.bfloat16, gen)
            for _ in range(2))
    if fmt == "int8":
        k, v = quantize_int8(k, axis=-1), quantize_int8(v, axis=-1)
    perm = torch.randperm(num_pages, generator=gen, device="cuda")
    table = perm[:batch * P].reshape(batch, P).to(torch.int32)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32,
                                 device="cuda"), table


def surface_phase(gen) -> dict:
    """B14 and B12 on their path, the package's public surface (neither
    lies on a model path): FA1 through `flash_attention_v1` and the
    separate-array decode through `paged_decode_attention` at the repo's
    benchmark shapes, the counts zeroed just before and read just after;
    then each output against its plain version and the device times (FA1
    beside B1 at the same shape: the FA1/FA2 gap)."""
    import tiny_flash_attention_tpu_torch as tfa
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        flash_attention_v1_plain)
    from tiny_flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_plain)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_attention, pack_paged_cache)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    v1_in = [(randn(qs, dt, gen), randn(ks, dt, gen), randn(ks, dt, gen))
             for _, qs, ks, dt, _ in V1_CASES]
    b12_in = [b12_inputs(gen, fmt, lens) for _, fmt, lens in B12_CASES]

    # ---- the main path: counts zeroed just before, read just after ----
    tfa.flash_attention_v1.launches = 0
    paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    v1_out = [tfa.flash_attention_v1(q, k, v, causal=case[4],
                                     return_lse=True)
              for case, (q, k, v) in zip(V1_CASES, v1_in)]
    b12_out = [paged_decode_attention(*x) for x in b12_in]
    torch.cuda.synchronize()
    launches = {"flash_v1": tfa.flash_attention_v1.launches,
                "paged_decode_separate": paged_decode_attention.launches}
    # ---------------------------------------------------------------------
    want = {"flash_v1": len(V1_CASES),
            "paged_decode_separate": len(B12_CASES)}
    log(f"B14/B12 surface: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"surface launches {launches} != {want}")

    rows = {}
    for (name, qs, ks, dt, causal), (q, k, v), (out, lse) in zip(
            V1_CASES, v1_in, v1_out):
        sc = qs[-1] ** -0.5
        ref, ref_lse = flash_attention_v1_plain(q, k, v, causal=causal,
                                                sm_scale=sc)
        err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
        atol = tolerance_for(dt)
        ok = err <= atol and lse_err <= atol and bool(
            torch.isfinite(out).all())
        mask = None
        if causal and qs[2] != ks[2]:
            mask = torch.ones(qs[2], ks[2], dtype=torch.bool,
                              device="cuda").tril(ks[2] - qs[2])
        t_kernel = cuda_time_ms(lambda: tfa.flash_attention_v1(
            q, k, v, causal=causal), iters=10)["median_ms"]
        t_fa2 = cuda_time_ms(lambda: flash_attention(q, k, v, causal=causal),
                             iters=10)["median_ms"]
        t_plain = cuda_time_ms(lambda: flash_attention_v1_plain(
            q, k, v, causal=causal, sm_scale=sc), iters=5)["median_ms"]
        t_sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None),
            iters=10)["median_ms"]
        bound_ms, bound_by = flash_bound(q, k, causal)
        log(f"flash_v1 {name}: q{qs} kv{ks} {str(dt).split('.')[-1]} causal="
            f"{causal} | out err {err:.3e} lse err {lse_err:.3e} (gate "
            f"{atol:.0e}) | FA1 kernel {t_kernel:.4f} ms, B1 (FA2) "
            f"{t_fa2:.4f} ms: FA1/FA2 {t_kernel / t_fa2:.2f}x | plain "
            f"{t_plain:.4f} ms sdpa {t_sdpa:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"FA1 kernel disagrees with plain: {name}")
        rows[name] = {"max_abs_err": max(err, lse_err), "ms": t_kernel,
                      "plain_ms": t_plain, "library_ms": t_sdpa,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "fa2_ms": t_fa2}
    del v1_in, v1_out

    for (name, fmt, _), (q, k, v, lengths, table), (out, lse) in zip(
            B12_CASES, b12_in, b12_out):
        sc = q.shape[-1] ** -0.5
        ref, ref_lse = paged_decode_plain(q, k, v, lengths, table,
                                          sm_scale=sc)
        err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
        ok = (err <= DECODE_OUT_GATE and lse_err <= DECODE_LSE_GATE
              and bool(torch.isfinite(out).all()))
        t_kernel = cuda_time_ms(lambda: paged_decode_attention(
            q, k, v, lengths, table), iters=20)["median_ms"]
        t_plain = cuda_time_ms(lambda: paged_decode_plain(
            q, k, v, lengths, table, sm_scale=sc), iters=5)["median_ms"]
        kv = k.values if fmt == "int8" else k
        bound_ms, bound_by = decode_bound(q, kv, lengths, table, 128)
        extra = ""
        if fmt == "bf16":      # B4 over the same K/V, packed into fused pages
            fused = pack_paged_cache(k, v)
            t_b4 = cuda_time_ms(lambda: fused_paged_decode_attention(
                q, fused, lengths, table, page_size=128),
                iters=20)["median_ms"]
            extra = f" | B4 on the same K/V fused {t_b4:.4f} ms"
            del fused
        kv_bytes = bound_ms * 1e-3 * PEAK_BYTES_PER_S
        log(f"paged_decode_separate {name}: q{tuple(q.shape)} pages"
            f"{tuple(kv.shape)} lengths {lengths.tolist()} | out err "
            f"{err:.3e} (gate {DECODE_OUT_GATE:.0e}) lse err {lse_err:.3e} "
            f"(gate {DECODE_LSE_GATE:.0e}) | kernel {t_kernel:.4f} ms plain "
            f"{t_plain:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) | "
            f"{kv_bytes / (t_kernel * 1e-3) / 1e9:.1f} GB/s{extra} | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"B12 kernel disagrees with plain: {name}")
        rows[name] = {"max_abs_err": max(err, lse_err), "ms": t_kernel,
                      "plain_ms": t_plain, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return {"launches": launches, "rows": rows}


# (name, q shape, kv shape, window, segment bounds): the JAX window
# benchmark (attention_bench.py:171-193), the windowed engine's prefill, a
# decode offset, and the window with segment ids
WINDOW_CASES = [
    ("bench s8192 w1024", (1, 8, 8192, 128), (1, 2, 8192, 128), 1024, None),
    ("engine prefill 8 x 2048 w1024", (8, 8, 2048, 128), (8, 2, 2048, 128),
     1024, None),
    ("decode offset q128/kv2048 w512", (2, 8, 128, 128), (2, 2, 2048, 128),
     512, None),
    ("segments (37, 300, 650) w200", (2, 8, 700, 128), (2, 2, 700, 128), 200,
     (37, 300, 650)),
]


def check_window(name, q_shape, kv_shape, window, bounds, gen) -> dict:
    """B1 with a window against its plain version, timed beside B1 causal
    without the window and SDPA with a boolean band mask; without segment
    ids also B11's non-jagged entry with the window. The bound counts
    the in-window pairs (w(w+1)/2 + (S - w)w a head at the bench shape) and
    the K/V rows some window needs."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    b, hq, q_len, d = q_shape
    kv_len = kv_shape[2]
    q = randn(q_shape, torch.bfloat16, gen)
    k, v = (randn(kv_shape, torch.bfloat16, gen) for _ in range(2))
    pos = torch.arange(q_len, device="cuda")[:, None] + kv_len - q_len
    cols = torch.arange(kv_len, device="cuda")[None, :]
    band = (cols <= pos) & (cols > pos - window)            # (q_len, kv_len)
    seg = None
    mask = band[None, None]
    if bounds is not None:
        seg = segment_ids(b, q_len, bounds)
        mask = band[None] & (seg[:, :, None] == seg[:, None, :])
        mask = mask[:, None]
    pairs = float(mask.expand(b, 1, q_len, kv_len).sum())
    needed = float(mask.any(dim=-2).expand(b, 1, kv_len).sum())
    nbytes = ((2 * q.numel() + 2 * needed * kv_shape[1] * d) * 2
              + q[..., 0].numel() * 4 + (2 * seg.numel() * 4 if seg
                                         is not None else 0))
    bound = _bound(4.0 * d * hq * pairs, nbytes, torch.bfloat16)
    ids = None if seg is None else (seg, seg)
    row = time_masked(
        f"B1 window {name}", q, k, v,
        kernel=lambda: flash_attention(q, k, v, causal=True, window=window,
                                       segment_ids=ids, return_lse=True),
        plain=lambda: flash_attention_plain(
            q, k, v, causal=True, sm_scale=d ** -0.5, window=window,
            segment_ids=ids, return_lse=True),
        sdpa_mask=mask, sdpa_causal=False, bound=bound)
    t_causal = cuda_time_ms(lambda: flash_attention(
        q, k, v, causal=True, segment_ids=ids), iters=5)["median_ms"]
    log(f"B1 window {name}: {row['ms']:.4f} ms against B1 causal without "
        f"the window {t_causal:.4f} ms ({t_causal / row['ms']:.2f}x); "
        f"{pairs / (b * q_len):.1f} visible columns a row")
    row["causal_ms"] = t_causal
    if seg is None:
        # B11's non-jagged entry takes the same launch: bit-equal output
        got = flash_attention_rowloop(q, k, v, causal=True, window=window)
        want = flash_attention(q, k, v, causal=True, window=window,
                               return_lse=True)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"windowed row loop differs from B1: {name}")
        t_row = cuda_time_ms(lambda: flash_attention_rowloop(
            q, k, v, causal=True, window=window), iters=5)["median_ms"]
        log(f"B11 window {name} (non-jagged entry): {t_row:.4f} ms, output "
            f"bit-equal to B1's; bound {bound[0]:.4f} ms ({bound[1]})")
        row["rowloop_ms"] = t_row
    return row


def ring_bound(q, pages, lengths, window) -> tuple[float, str]:
    """Least time for one ring-mode decode: the K and V rows of the last
    min(length, window) tokens read once (int8: with their scales), q, out,
    the LSE and the lengths; 4 * d flops per (q head, token)."""
    batch, hq, d = q.shape
    hkv = pages.shape[0]
    tokens = float(np.minimum(lengths.cpu().numpy(), window).sum())
    scale_bytes = 8 if pages.dtype == torch.int8 else 0
    nbytes = (tokens * hkv * (2 * d * pages.element_size() + scale_bytes)
              + 2 * q.numel() * q.element_size() + batch * hq * 4 + batch * 4)
    return _bound(4.0 * hq * d * tokens, nbytes, q.dtype)


def check_ring(name, fmt, gen, *, window=1024, batch=8, hq=8, hkv=2, d=128,
               ps=128, P=16) -> dict:
    """B4's ring mode against its plain version over a table that has
    wrapped (the windowed engine's geometry: 16 pages of 128 a slot)."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_attention, fused_paged_decode_plain,
        pack_paged_cache)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    num_pages = batch * P + 8
    q = randn((batch, hq, d), torch.bfloat16, gen)
    pages = pack_paged_cache(
        randn((hkv, num_pages, ps, d), torch.bfloat16, gen),
        randn((hkv, num_pages, ps, d), torch.bfloat16, gen), fmt)
    perm = torch.randperm(num_pages, generator=gen, device="cuda")
    table = perm[:batch * P].reshape(batch, P).to(torch.int32)
    lengths = torch.tensor([1, window, window + 65, P * ps, P * ps + 1,
                            P * ps + 700, 3 * P * ps + 5, 9000],
                           dtype=torch.int32, device="cuda")
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    ref, ref_lse = fused_paged_decode_plain(q, pages, lengths, table,
                                            page_size=ps, sm_scale=d ** -0.5,
                                            window=window)
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    ok = (err <= DECODE_OUT_GATE and lse_err <= DECODE_LSE_GATE
          and bool(torch.isfinite(out).all()))
    t_kernel = cuda_time_ms(lambda: fused_paged_decode_attention(
        q, pages, lengths, table, page_size=ps, window=window),
        iters=20)["median_ms"]
    t_plain = cuda_time_ms(lambda: fused_paged_decode_plain(
        q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
        window=window), iters=5)["median_ms"]
    bound_ms, bound_by = ring_bound(q, pages, lengths, window)
    log(f"ring decode {name}: q{tuple(q.shape)} pages{tuple(pages.shape)} "
        f"table{tuple(table.shape)} window {window} lengths "
        f"{lengths.tolist()} | out err {err:.3e} (gate "
        f"{DECODE_OUT_GATE:.0e}) lse err {lse_err:.3e} (gate "
        f"{DECODE_LSE_GATE:.0e}) | kernel {t_kernel:.4f} ms plain "
        f"{t_plain:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ring decode disagrees with plain: {name}")
    return {"max_abs_err": max(err, lse_err), "ms": t_kernel,
            "plain_ms": t_plain, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by}


SWA_WINDOW = 1024        # attention_bench.py:173, the Mistral-style window
SWA_PAGES_PER_SEQ = 16   # ring capacity 2048 >= 1024 + 2 x 128
SWA_CHUNKS = 8           # 8 x steps(32): 256 decode steps


def swa_phase(seed: int) -> dict:
    """The cell swa_serving: the engine model with attn_window=1024 served
    from a ring cache (page_size 128, 8 slots, 16 pages a slot), 8 prompts
    of 1792-2048 tokens admitted with one add_requests, then 256 decode
    steps by steps(32), so every ring wraps. Launch counts per admission and
    step; the first decode step and the first step after every ring has
    wrapped against the same step with the plain versions on a copy of the
    cache; tokens against their argmax; the ring decode's time at the
    wrapped cache beside B4 without a window over a cache of that length."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.models.engine import (
        InferenceEngine, Request)
    from tiny_flash_attention_tpu_torch.models.inference import decode_step
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    cfg = dataclasses.replace(engine_config(), attn_window=SWA_WINDOW)
    max_seqs, ps, n_chunk = 8, 128, 32
    cap = SWA_PAGES_PER_SEQ * ps
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    eng = InferenceEngine(cfg, params,
                          num_pages=max_seqs * SWA_PAGES_PER_SEQ + 8,
                          page_size=ps, max_seqs=max_seqs,
                          pages_per_seq=SWA_PAGES_PER_SEQ, seed=seed,
                          device="cuda")
    rng = np.random.default_rng(seed)
    lens = rng.integers(1792, 2049, max_seqs)
    n_steps = n_chunk * SWA_CHUNKS
    # none finishes: the check's extra step and the profile's two windows
    max_new = 1 + n_steps + 1 + 2 * PROFILE_STEPS + 8
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).tolist(), max_new)
            for n in lens]
    counters = [(flash_attention, "launches"),
                (flash_attention, "window_launches"),
                (fused_paged_decode_attention, "launches"),
                (fused_paged_decode_attention, "ring_launches"),
                (fused_page_append, "launches")]

    def snapshot():
        return dict(pages=[p.clone() for p in eng.cache.pages],
                    table=eng.cache.page_table.copy(),
                    lengths=eng.cache.lengths.copy(),
                    last=eng.last_token.copy())

    # ---- the main path: counts zeroed just before, read just after ----
    for fn, name in counters:
        setattr(fn, name, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.add_requests(reqs)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = snapshot()
    chunk_s = []
    for _ in range(SWA_CHUNKS):
        t0 = time.perf_counter()
        eng.steps(n_chunk)            # ends in a device-to-host copy
        chunk_s.append(time.perf_counter() - t0)
    counts = [getattr(fn, name) for fn, name in counters]
    launches = {"flash_fwd": counts[0], "flash_fwd_window": counts[1],
                "paged_decode": counts[2], "paged_decode_ring": counts[3],
                "page_append": counts[4]}
    # ---------------------------------------------------------------------
    L = cfg.n_layers
    want = {"flash_fwd": L, "flash_fwd_window": L, "paged_decode": 0,
            "paged_decode_ring": n_steps * L, "page_append": n_steps * L}
    ends = eng.cache.lengths.copy()
    log(f"swa_serving: window {SWA_WINDOW}, ring capacity {cap}; prompts "
        f"{lens.tolist()}; lengths after {n_steps} steps {ends.tolist()}; "
        f"launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"swa_serving launches {launches} != {want}")
    if not (ends > cap).all():
        raise AssertionError("a ring did not wrap")
    for r in reqs:
        assert len(r.generated) == 1 + n_steps, len(r.generated)

    def step_logits(snap):
        dec, _ = decode_step(
            cfg, params, [p.clone() for p in snap["pages"]],
            torch.as_tensor(snap["last"], device="cuda"),
            torch.as_tensor(snap["lengths"], device="cuda"),
            torch.as_tensor(snap["table"], device="cuda"), page_size=ps,
            fmt="bf16")
        return dec

    wrapped = snapshot()
    errs = []
    for label, snap, want_tok in (
            ("first decode step", first, [r.generated[1] for r in reqs]),
            (f"first step after every ring wrapped (lengths "
             f"{wrapped['lengths'].min()}-{wrapped['lengths'].max()})",
             wrapped, None)):
        got = step_logits(snap)
        with plain_kernels():
            ref = step_logits(snap)
        scale = float(ref.abs().max())
        err = max_err(got, ref)
        gate = ENGINE_LOGIT_GATE * scale
        argmax = got.argmax(-1).tolist()
        if want_tok is None:          # the engine's next step takes it
            eng.step()
            want_tok = [r.generated[-1] for r in reqs]
        log(f"swa_serving {label}: logits vs plain versions max err "
            f"{err:.4f} (gate {gate:.4f} = {ENGINE_LOGIT_GATE:.1%} of max "
            f"|logit| {scale:.3f}); tokens {want_tok} vs argmax {argmax}")
        if err > gate or not torch.isfinite(got).all():
            raise AssertionError(f"swa_serving logits disagree: {label}")
        if want_tok != argmax:
            raise AssertionError(f"swa_serving tokens are not the argmax: "
                                 f"{label}")
        errs.append(err / scale)
    tok_s = max_seqs * n_chunk / chunk_s[-1]
    log(f"swa_serving timing: admission of 8 prompts (L_pad "
        f"{-(-int(lens.max()) // ps) * ps}) {prefill_ms:.1f} ms; decode "
        f"steps({n_chunk}) {[round(x * 1e3, 2) for x in chunk_s]} ms -> "
        f"{tok_s:.0f} tokens/s (8 slots, last chunk)")
    profile_window(f"per windowed decode step (steps({PROFILE_STEPS}))",
                   lambda: eng.steps(PROFILE_STEPS), PROFILE_STEPS)

    # the ring decode at the wrapped cache (O(window)) beside B4 without a
    # window over a bf16 cache holding every token of the same lengths
    page_table, lengths = eng.cache.device_views()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qd = randn((max_seqs, cfg.n_q_heads, cfg.d_head), torch.bfloat16, gen)
    t_ring = cuda_time_ms(lambda: fused_paged_decode_attention(
        qd, eng.cache.pages[0], lengths, page_table, page_size=ps,
        window=SWA_WINDOW), iters=20)["median_ms"]
    P = -(-int(lengths.max()) // ps)
    full = randn((cfg.n_kv_heads, max_seqs * P + 1, 2 * ps, cfg.d_head),
                 torch.bfloat16, gen)
    table = torch.arange(max_seqs * P, dtype=torch.int32,
                         device="cuda").reshape(max_seqs, P)
    t_full = cuda_time_ms(lambda: fused_paged_decode_attention(
        qd, full, lengths, table, page_size=ps), iters=20)["median_ms"]
    log(f"swa_serving ring decode at the wrapped cache (lengths "
        f"{lengths.tolist()}, window {SWA_WINDOW}): {t_ring:.4f} ms against "
        f"B4 without a window over the same lengths {t_full:.4f} ms "
        f"({t_full / t_ring:.2f}x)")
    return {"launches": launches, "logit_err": max(errs), "tok_s": tok_s,
            "ring_ms": t_ring, "full_ms": t_full}


def time_sampled_decode(eng, n_chunk: int) -> None:
    """One greedy and one sampled chunk back to back, host clock: the
    sampled path draws its uniforms on the device and, like the greedy
    one, syncs with the host once per chunk."""
    rates = {}
    for label, temp in (("greedy", 0.0), ("sampled", 1.0)):
        eng.temps[:] = temp
        t0 = time.perf_counter()
        eng.steps(n_chunk)            # ends in a device-to-host copy
        dt = time.perf_counter() - t0
        rates[label] = (dt, len(eng.temps) * n_chunk / dt)
    eng.temps[:] = 0.0
    log("engine decode, one chunk each: " + "; ".join(
        f"{k} steps({n_chunk}) {dt * 1e3:.2f} ms -> {r:.0f} tokens/s"
        for k, (dt, r) in rates.items()) + " (temperature 1 for sampled)")


def profile_window(label: str, fn, n: int) -> None:
    """Where the time of fn() goes, per unit of n: the device time of its
    kernels from torch.profiler, against fn's wall time taken without the
    profiler (which slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # user annotations (the optimizer's step) span kernels counted anyway
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"profile {label}: the profiler recorded no device time "
            "(not measured)")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
    log(f"profile {label}: wall {wall_ms:.3f} ms unprofiled, device "
        f"kernels {busy_ms:.3f} ms, device busy {busy_ms / wall_ms:.1%}, "
        f"{sum(e.count for e in kernels) / n:.0f} kernel launches")
    for e in kernels[:8]:
        log(f"  {e.self_device_time_total / n / 1e3:.4f} ms "
            f"{e.count / n:5.1f}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; it runs on the card",
              file=sys.stderr)
        return 1
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.models.inference import (
        prefill_forward_batched)

    # the JAX reference's arithmetic: f32 products in full f32 (no TF32),
    # bf16 products accumulated in f32 and rounded once
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    info = gpu_info()
    log(f"card: {info}")
    t_build = _build.build()
    log(f"build: {_build.sources()} in {t_build:.1f} s (nvcc, parallel)")
    for name in _build.sources():
        text = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                text))
        log(f"  {name}: {len(regs)} kernel instances, at most {max(regs)} "
            f"registers, {spills} bytes of spill stores in all (ptxas)")
        if len(regs) <= 8:
            log("    registers: " + ", ".join(instance_registers(text)))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for case in FLASH_CASES:
        check_flash(*case, gen, iters=5 if case[1][2] >= 8192 else 10)
    seg_err = max(check_segments(*case, gen) for case in SEG_CASES)
    rowloop_err = check_rowloop(gen)
    q, pages, lengths, table = decode_inputs(gen)
    check_decode("random pages", q, pages, lengths, table, 128)
    check_decode("column slice (16 of 32 pages)", q, pages,
                 lengths.clamp(max=16 * 128), table[:, :16], 128)
    # the quantized path's kernels: int8 decode at the three page geometries
    # of JAX's tests, the append in both formats (the engine's shape: 8
    # tokens, 2 kv heads of 128), the quantized matmul at every engine
    # projection at the decode step's 8 rows
    for ps, P in ((64, 64), (128, 32), (256, 16)):
        check_decode(f"int8 pages ps {ps}", *decode_inputs_int8(gen, ps=ps,
                                                                P=P), ps)
    append_rows = {(fmt, ps): check_append(f"{fmt} ps {ps}", fmt, ps, gen)
                   for fmt, ps in (("bf16", 128), ("int8", 64),
                                   ("int8", 128), ("int8", 256))}
    qmm_rows = {name: check_qmm(name, 8, k, n, "int8", gen)
                for name, k, n in QMM_SHAPES}
    check_qmm("lm_head, fp8 weight", 8, 1024, 32768, "fp8", gen)
    check_qmm("w_down, 3 rows", 3, 4096, 1024, "int8", gen)
    qmm_row_sweep(gen)
    qmm_split_sweep(gen)
    bwd_rows = [check_bwd(*case, gen, iters=5 if case[1][2] >= 8192 else 10)
                for case in BWD_CASES]
    window_rows = {case[0]: check_window(*case, gen) for case in WINDOW_CASES}
    ring_rows = {fmt: check_ring(f"{fmt} pages, wrapped table", fmt, gen)
                 for fmt in ("bf16", "int8")}
    surface = surface_phase(gen)
    check_not_ported_raise()

    run = engine_phase(SEED)
    eng, cfg = run["engine"], run["cfg"]
    profile_window(f"per decode step (steps({PROFILE_STEPS}), 8 slots)",
                   lambda: eng.steps(PROFILE_STEPS), PROFILE_STEPS)
    profile_window("per prefill of 4 x 2048 tokens",
                   lambda: prefill_forward_batched(cfg, eng.params,
                                                   run["long_tokens"]), 1)

    time_sampled_decode(eng, run["n_chunk"])

    quant = quant_serving_phase(SEED)
    ragged = ragged_admission_phase(SEED)
    enc = encoder_phase(SEED)
    swa = swa_phase(SEED)

    train = train_phase(SEED)
    for label, (step, *state) in train["states"].items():
        profile_window(f"per train step of {label} tokens",
                       lambda f=step, s=state: f(*s), 1)

    # each kernel at the shapes the main path gave it; the JSON row holds
    # the larger admission's times and the worst error of both
    first = check_flash("main path: 4 x L_pad 768 prefill",
                        (4, 8, 768, 128), (4, 2, 768, 128), torch.bfloat16,
                        True, gen)
    flash_row = check_flash("main path: 4 x L_pad 2048 prefill",
                            (4, 8, 2048, 128), (4, 2, 2048, 128),
                            torch.bfloat16, True, gen)
    slice_rows = time_ragged_kernels(gen, SEED)
    # B1's row: the batched admission's times, the worst error of every
    # main-path shape (segments included)
    flash_row["max_abs_err"] = max(
        flash_row["max_abs_err"], first["max_abs_err"], seg_err,
        *(slice_rows[k]["max_abs_err"]
          for k in ("packed with", "packed without", "encoder", "padded")),
        *(r["max_abs_err"] for r in window_rows.values()))
    rowloop_row = dict(slice_rows["jagged"])
    rowloop_row["max_abs_err"] = max(rowloop_row["max_abs_err"], rowloop_err)
    page_table, lengths = eng.cache.device_views()
    qd = randn((8, cfg.n_q_heads, cfg.d_head), torch.bfloat16, gen)
    decode_row = check_decode("main path: engine cache, layer 0", qd,
                              eng.cache.pages[0], lengths, page_table, 128)
    # the ring mode's errors join B4's row (bf16 pages) and its int8 row
    decode_row["max_abs_err"] = max(decode_row["max_abs_err"],
                                    ring_rows["bf16"]["max_abs_err"])
    eng8k = quant["engines"][(False, 7936)]
    page_table, lengths = eng8k.cache.device_views()
    int8_row = check_decode("main path: int8 engine cache at prompt 7936, "
                            "layer 0", qd, eng8k.cache.pages[0], lengths,
                            page_table, 128)
    int8_row["max_abs_err"] = max(int8_row["max_abs_err"],
                                  ring_rows["int8"]["max_abs_err"])
    qlaunch = quant["launches"]
    # B14's row: FA1 at the MHA headline shape, B12's: config 2 over bf16
    # pages; each with the worst error of its cases
    srows = surface["rows"]
    v1_row = dict(srows[V1_CASES[0][0]])
    v1_row["max_abs_err"] = max(srows[c[0]]["max_abs_err"] for c in V1_CASES)
    b12_row = dict(srows[B12_CASES[0][0]])
    b12_row["max_abs_err"] = max(srows[c[0]]["max_abs_err"]
                                 for c in B12_CASES)
    # the backward's rows: each kernel at the train step's 4 x 2048 shape
    # (the f32 kernels at the f32 train step's 1 x 1024, the first f32
    # case), the worst error over the cases of its dtype; the plain and
    # library times are those of the whole backward (one function computes
    # dq, dk, dv)
    bwd_replaces = ("tiny_flash_attention_tpu/ops/flash_tri_bwd.py:302; "
                    "tiny_flash_attention_tpu/ops/flash_tri_bwd.py:583; "
                    "tiny_flash_attention_tpu/ops/flash_bwd.py:436; "
                    "tiny_flash_attention_tpu/ops/flash_bwd.py:560; "
                    "tiny_flash_attention_tpu/ops/flash_bwd.py:609")

    def bwd_kernel(part, row, dtype, launches):
        worst = max(r["max_abs_err"] for r, c in zip(bwd_rows, BWD_CASES)
                    if c[3] == dtype)
        suffix = "_f32" if dtype == torch.float32 else ""
        return {"name": f"flash_bwd_{part}{suffix}", "route": "cuda",
                "source": "tiny_flash_attention_tpu_torch/csrc/flash_bwd.cu",
                "replaces": bwd_replaces, "launches": launches,
                "max_abs_err": worst, "ms": row["ms"][part],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound"][part][0],
                "bound_by": row["bound"][part][1],
                "library_ms": row["library_ms"]}

    f32_row, f32_case = next((r, c) for r, c in zip(bwd_rows, BWD_CASES)
                             if c[3] == torch.float32)
    if f32_case[1] != (TRAIN_F32[0], 8, TRAIN_F32[1], 128):
        raise AssertionError(f"the f32 row {f32_case[1]} is not the f32 "
                             f"train step's shape {TRAIN_F32}")
    bwd_kernels = [
        *(bwd_kernel(part, bwd_rows[0], torch.bfloat16,
                     train["launches"]["flash_bwd"])
          for part in ("prep", "main", "post")),
        *(bwd_kernel(part, f32_row, torch.float32,
                     train["launches"]["flash_bwd_f32"])
          for part in ("dq", "dkv"))]
    # flash_fwd runs on every main path but the jagged admission: its
    # launches are the engines' (the windowed one's included), the
    # encoder's and the train step's; paged_decode's include the windowed
    # engine's ring-mode launches
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash.py:533; "
                     "tiny_flash_attention_tpu/ops/flash_tri.py:336; "
                     "tiny_flash_attention_tpu/ops/flash_tri.py:658",
         "launches": run["launches"]["flash_fwd"] + qlaunch["flash_fwd"]
         + ragged["launches"]["flash_fwd"] + enc["launches"]
         + train["launches"]["flash_fwd"] + swa["launches"]["flash_fwd"],
         **flash_row},
        {"name": "flash_rowloop", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash_rowloop.py:332",
         "launches": ragged["launches"]["flash_rowloop"], **rowloop_row},
        {"name": "paged_decode", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": run["launches"]["paged_decode"]
         + qlaunch["paged_decode"] + ragged["launches"]["paged_decode"]
         + swa["launches"]["paged_decode_ring"], **decode_row},
        *bwd_kernels,
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": qlaunch["paged_decode_int8"], **int8_row},
        {"name": "page_append", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/page_append.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:281",
         "launches": run["launches"]["page_append"]
         + qlaunch["page_append"] + ragged["launches"]["page_append"]
         + swa["launches"]["page_append"],
         **append_rows[("int8", 128)]},
        {"name": "quant_matmul", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "tiny_flash_attention_tpu/ops/quant_matmul.py:84",
         "launches": qlaunch["quant_matmul"],
         **{k: v for k, v in qmm_rows["lm_head"].items() if k != "route_ms"}},
        {"name": "flash_v1", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_v1.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash_v1.py:144",
         "launches": surface["launches"]["flash_v1"],
         **{k: v for k, v in v1_row.items() if k != "fa2_ms"}},
        {"name": "paged_decode_separate", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_separate.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged.py:327",
         "launches": surface["launches"]["paged_decode_separate"],
         **b12_row},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
