#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --bwd-spread   # only the backward's spread, read
    python3 chip_smoke.py --rows         # only the head_dim-128 rows, timed
    python3 chip_smoke.py --cp           # only the context-parallel phase
    python3 chip_smoke.py --serve-sharded  # only the sharded-serving phase
    python3 chip_smoke.py --autotune     # only the autotuner's phase
    python3 chip_smoke.py --cpu-oracle   # only the native CPU oracle's
    python3 chip_smoke.py --train-sharded  # only the sharded-train phase

Builds the port's CUDA kernels from tiny_flash_attention_tpu_torch/csrc/
with nvcc and holds each kernel against its plain PyTorch version on the
card (the flash forward with and without segment ids, with the sliding
window, and its jagged row-loop mode; its quantized instances over int8
and fp8 K/V through flash_attention_quantized at the JAX package's two
quantized-prefill benchmarks and with each mask; the flash backward's
kernels (bf16:
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
train cell) and two f32 steps at 1 x 1024. Then head dims and groups no
instance of 64/128 columns covers: every kernel at 72/80/96 and groups
3-16, the wide instances at 136/192/256 and groups 1/2/8 (B1, the
backward, the decodes over bf16 and int8 pages, the append), and three
models at published widths, 4 layers each, served over bf16 and int8
pages (Phi-3-mini's, Llama-3.2-3B's and Gemma-2B's, head_dim 256, one kv
head), two of them also trained (Phi-3-mini's, Gemma-2B's). Then the f32
path at head_dim 256: B1's wide f32 instance (Gemma-2B's (1,8,2048,256)
causal, bit-identical calls, planted faults; 192 padded, the window, ids,
the jagged mode), the f32 backward (bit-identical calls), the decodes with
f32 q over f32 and int8 pages and the append into them, and the
Gemma-2B-width model in f32 served over f32 and int8 pages and trained at
1 x 2048. Then head_dim 256 in the quantized forward and FA1 (the phase
`wide_quant_v1_phase`): flash_attention_quantized at Gemma-2B's widths on
the JAX package's int8 prefill pattern, (2,8,2048,256) against
(2,1,2048,256), with bf16 q over int8 and f32 q over int8 and e4m3, and on
its fp8 chunk pattern, (1,8,4096,256) bf16 q against (1,1,32768,256) e4m3
K/V at offset 28672; flash_attention_v1 at (2,8,2048,256) MHA bf16
(causal and not) and (2,8,1024,256) f32; each beside SDPA and B1 on the
same K/V, with the planted faults of the 128 rows; the masks and 192
(padded, its copies counted) at smaller shapes. Then context parallelism
(`context_parallel_phase`, parallel/ring.py and parallel/sharded.py on
torch.distributed, worlds of ranks spawned by parallel/world.py): a world
of 1 on NCCL at 2048 tokens, where ring, zigzag ring, Ulysses, all-gather
and sharded flash each give B1's bits, and worlds of 2 and 4 ranks sharing
the card over gloo at Llama-3.2-3B's attention widths (24 q / 8 kv heads
of 128, bf16): ring causal and not, zigzag and Ulysses at 1 x 32768,
all-gather at 16384, sharded flash on a (data 2, model 2) mesh at 2 x
4096, ring and zigzag at 2048, each held against the plain version over
the whole sequence (one q head at a time) and against B1 over it, each
rank's launches asserted, three planted
faults (the ring rotated the wrong way, a merge dropped, zigzag not
unpermuted) that the gate must reject. Then sharded serving
(`sharded_serving_phase`, parallel/serve.py): ShardedInferenceEngine at
Llama-3.2-3B's widths (4 layers, bf16, seed 0; the dims engines' 8 prompts,
64 greedy decode steps over bf16 and int8 pages, then a sampled chunk) in
a world of 1 on NCCL, where it gives the single-card engine's tokens and
logits bit for bit, and in gloo worlds of 2 ((data 1, model 2); also the
engine benchmark's model in f32) and 4 ((2, 2) with page groups, (1, 4))
sharing the card, against the single-card engine run in this process:
every greedy step's logits, the step fed the single-card engine's
tokens, within 1.5 % of the largest |logit|, greedy tokens equal up to
the first near tie, local pages after the admissions and after those
steps within the bf16 gate, B1, B4 and B5 on each rank's own inputs
against their plain versions, every rank's tokens the same and its B1, B4
and B5 launches asserted, and two planted faults (an all-reduce after
w_down skipped, data group 1 reading at group 0's offset) that must
fail; the same engine admitting the prompts packed (page and pow2
buckets: B1 with segment ids and the pack's tile table on every rank) and
jagged (B11) on (1, 1) NCCL (the single-card engine's bits) and (1, 2),
(2, 2) gloo, each against the single-card engine admitted the same way
(the first tokens' logits too), B1 with ids or B11 on each rank's inputs
against its plain version, and rank 0's pack offsets shifted by one page
planted, which must fail the logit gate. Before the engines, the
autotuner (`autotune_phase`: utils/autotune.py at an f32 head_dim-256, a
bf16 head_dim-96 and a bf16 head_dim-128 prefill, every candidate timed,
the winner held to the plain version and to the call without config,
the memo and the JSON cache; default_config passed explicitly giving a
call's bits) and the native CPU oracle (`cpu_oracle_phase`: cpu.py built
from cpp/attn.cpp on the card's host, its four functions against the
plain reference and B1 copied back). Then the sharded train step (`sharded_train_phase`,
parallel/train.py's make_train_step on a mesh): the train cell's model at
4 x 2048 in a world of 1 on NCCL, where three AdamW steps give the
single-card step's gradients, losses and leaves bit for bit, and on (2,
1), (1, 2) and (2, 2) gloo meshes sharing the card, the windowed model at
1 x 8192, the model in f32 at 1 x 1024 and Llama-3.2-3B's widths (group
3) at 1 x 2048 on (1, 2), against the single-card step run in this
process: each rank's gradients after one SGD step against its blocks of
the single card's (relative Frobenius, the train cells' gates), the first
loss within 0.1 %, three AdamW steps finite and falling, every rank's
losses and replicated leaves the same, B1 and the backward on each rank's
own q/k/v/dO of one layer against their plain versions, each rank's
launches n_layers a step, and two planted faults (f's backward all-reduce
dropped, the data mean taken as a sum) that must fail the gradient gate
by five times; then two processes configured by the environment alone
(initialize_multihost with gloo, make_hybrid_mesh(num_slices=2)) take two
SGD steps within 0.1 % of the single card's losses. The flash
forward's and FA1's
bf16 out is also gated row by row (utils/testing.py), and at causal 2048
and 8192 (FA1: 2048 in bf16 and 1024 in f32) the gate must reject faults
planted in the plain version (a stale V tile, a dropped kv tile; for FA1
also a q tile's state not reloaded at one kv step); at both quantized
benchmark shapes the quantized gate must reject a bf16 stage left from the
previous tile, k scales shifted by one token and v scales ignored. Two
runs of the backward must give the same
bits (bwd_spread for bf16, check_bwd for f32: their sums run in a fixed
order). The decodes are held against
their plain version at the kernel's own split count and unsplit, the
quantized matmul at every engine projection at 8 rows and at 1. It fails
if a kernel does not build, launch or agree, if a kernel of the JSON line
never launched in the run, if the bf16-q instances of
the flash forward (over bf16 K/V and over int8/e4m3 payloads) or FA1's
bf16 instances are not on
wgmma (no HGMMA, or any HMMA, in their SASS), if a path did not go through
its kernels, if a decode step's launches differ from the parent tree's
(303 bf16, 303 / 299 int8 KV with bf16 / int8 weights, 302 windowed), if
two backward runs differ in any bit, if a path's output disagrees with its
plain version, if the
train step's loss is not finite, does not fall, or its gradients disagree
with those through the plain attention, or if a backward through an entry
whose JAX kernel has no VJP does not raise.

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
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 on the
# CUDA cores (the f32 kernel never uses TF32), HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
PROFILE_STEPS = 8
PROFILE_SETTLE_S = 0.1   # the profiler's pause before the profiled run
# The decode kernel and its plain version share their arithmetic (q scaled
# in bf16, p rounded to bf16 before PV), so they agree far inside the
# generic bf16 gate: earlier runs read at most 1.95e-3 on out (one bf16 ulp
# in [0.25, 0.5)) and 9.5e-7 on the LSE.
DECODE_OUT_GATE = 4e-3
DECODE_LSE_GATE = 1e-4
# The absolute out gate fits no row length: at 8016 tokens |out| is about
# 0.02, so 4e-3 lets a V-side fault through. Out is also held row by row
# against the plain version at the kernel's own splits (the same partials
# and merge): each (sequence, q head) row's largest error over that row's
# largest |out|, at most two bf16 ulps of that value, as B1's row gate.
# Planted V-side faults (a stale V chunk, a wrong V-scale row) must fail it.
DECODE_ROW_GATE = 2.0 ** -6
# Engine logits against the plain attention path, as a share of the
# largest |logit|: earlier runs read 0.0391 of 4.688 (0.83 %) at prefill
# and 0.0352 (0.76 %) at the first decode step.
ENGINE_LOGIT_GATE = 1.5e-2
# ... in f32 (TF32 off): bf16's gate is bf16 rounding of the activations,
# which f32 does not have; every kernel of the f32 path holds its plain
# version to 2e-5, and sums in other orders through 4 layers stay orders
# below 1e-3 of the largest |logit|: runs at Gemma-2B's widths read
# 9.8e-6 of 5.114 at prefill and 3.1e-6 at the first decode step.
ENGINE_F32_LOGIT_GATE = 1e-3
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
# The decodes' design, for the kernels line.
DECODE_DESIGN = ("split-KV in one launch: grid (splits, kv heads, sequences), "
                 "512-token page-aligned splits covering the table width; "
                 "each warp's 32-token chunks land by cp.async.bulk through "
                 "a ring in shared memory; the last split to arrive merges "
                 "the partials in split order (exact LSE combine)")
# ... and of the run-time width instances (every head_dim up to 256 and page
# size the compiled widths do not take)
WIDTHS_DESIGN = ("instances of width 64, 128 and 256 reading rows of any "
                 "head_dim up to the width in place: each token's K and V "
                 "rows copied by cp.async in the largest pieces that divide "
                 "a row (a page edge anywhere in a chunk), zeros past d in "
                 "shared memory, int8 scale bytes read by the token's lane "
                 "a chunk ahead; split-KV in one launch as the compiled "
                 "widths (512-token page-aligned splits, the in-order "
                 "merge)")
# Launches per decode step in the profiled engine cells, the parent tree's
# (PERF.md §5): a redesigned kernel keeps one launch per layer a step.
STEP_LAUNCHES = {"bf16": 303, "int8 KV, bf16 weights": 303,
                 "int8 KV, int8 weights": 299, "windowed": 302}
# One train step's gradients through the kernels against those through
# attn_impl="reference", per parameter, by relative Frobenius norm: earlier
# runs read 1.89e-2 (bf16 activations round at other points in the two
# attention paths).
TRAIN_GRAD_GATE = 3e-2
# ... in f32 (TF32 off): the kernels' f32 attention against the plain
# attention, both in f32 FMAs with sums in other orders, through 4 layers:
# 1e-3 of each gradient's norm, 30x under bf16's; runs at Gemma-2B's
# widths read 4.3e-6.
TRAIN_F32_GRAD_GATE = 1e-3

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
    ("causal 1024 f32, the f32 train step's shape", (1, 8, 1024, 128),
     (1, 2, 1024, 128), torch.float32, True),
]
# the f32 train step's attention (q, kv shapes): B1's f32 row
F32_FWD_SHAPE = ((1, 8, 1024, 128), (1, 2, 1024, 128))


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


def kernel_label(name: str) -> str:
    """'kernel<template args>' for a mangled kernel name, read from the
    name itself, where each identifier is preceded by its length
    (flash_fwd_bf16_kernel<128,0,1>: head_dim 128, no window, int8
    payloads); the name's first 60 characters otherwise."""
    # every digit run and its suffixes: a hash may end in a digit, and a
    # digit run inside the anonymous namespace's hash can measure out a
    # longer "identifier" that ends where the kernel's does; the kernel's
    # own name is the shortest
    found = []
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", name):
        start = m.start() + len(m.group(1))
        ident = name[start:start + int(m.group(1))]
        args = re.match(r"I((?:L[a-z]\d+E)+)E", name[start + len(ident):])
        if ident.endswith("_kernel") and args:
            nums = re.findall(r"(\d+)E", args.group(1))
            found.append(f"{ident}<{','.join(nums)}>")
    return min(found, key=len) if found else name[:60]


def instance_registers(ptxas_log: str) -> list:
    """'kernel<template args>: registers/spill bytes' for each kernel
    instance in a ptxas -v log."""
    return [f"{kernel_label(name)}: {regs}/{spills}"
            for name, spills, regs in re.findall(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", ptxas_log, re.S)]


def spilling_instances(ptxas_log: str, every: bool = False) -> list:
    """'kernel<template args>: registers/spill bytes' for each kernel
    instance of a ptxas -v log that spills (with `every`, for each),
    demangled by c++filt where the toolkit's host has it (the decodes'
    instances take types as template arguments, which `kernel_label` does
    not read)."""
    found = [(name, int(spills), regs) for name, spills, regs in re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill "
        r"stores.*?Used (\d+) registers", ptxas_log, re.S)
        if every or int(spills)]
    names = [name for name, _, _ in found]
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True, timeout=60).stdout
        demangled = out.splitlines()
        if len(demangled) == len(names):
            names = [re.sub(r"\(anonymous namespace\)::|\(.*$", "", x)
                     .replace("__nv_bfloat16", "bf16")
                     .replace("signed char", "i8") for x in demangled]
    return [f"{name}: {regs}/{spills}"
            for name, (_, spills, regs) in zip(names, found)]


def wgmma_instructions(lib_path: str) -> dict:
    """{kernel label: (HGMMA count, HMMA count)} in the SASS of a built
    library (cuobjdump -sass): which tensor-core path each kernel took,
    wgmma (HGMMA) or mma.sync (HMMA)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, label = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = kernel_label(m.group(1))
            counts[label] = [0, 0]
        elif label is not None:
            counts[label][0] += "HGMMA" in line
            counts[label][1] += bool(re.search(r"\bHMMA\b", line))
    return {k: tuple(v) for k, v in counts.items()}


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


def gate_text(dtype) -> str:
    """The flash forward's gates for `dtype`, as the log prints them."""
    from tiny_flash_attention_tpu_torch.utils.testing import (
        BF16_LSE_GATE, BF16_ROW_GATE, tolerance_for)

    atol = tolerance_for(dtype)
    if dtype != torch.bfloat16:
        return f"gate {atol:.0e}"
    return (f"gates: {atol:.0e}; at the fold row {BF16_ROW_GATE:.4e} of the "
            f"row's max |out|, lse {BF16_LSE_GATE:.0e}")


def flash_readings(errs, folded=None) -> str:
    text = f"out err {errs['out']:.3e} lse err {errs['lse']:.3e}"
    if folded is not None:
        # the bare out gate above head_dim 256 (utils/testing.py)
        text += (f" (out beyond one bf16 ulp of |plain| "
                 f"{errs['spaced']:.3e})")
        text += (f"; at the fold: row {folded['row']:.3e} (out err "
                 f"{folded['out']:.3e}) lse err {folded['lse']:.3e}")
    return text


def planted_faults(name, q, k, v, sm_scale) -> None:
    """Faults of B1's pipeline, planted in the rows of the last q tile (of
    q's dtype's instance: the rows that read the most kv tiles) of the
    plain version on the folded q, put through the same gate as the
    kernel's output: (1) kv tile j's V replaced by tile j - 1's, as a stale
    ring stage would give; (2) kv tile j dropped (its columns masked by a
    segment id); j the middle tile; f32 also (3) the tile's first run of
    kv tiles (`fwd_f32_split`'s, at most half the tiles) lost in the
    merge. Each must fail the gate."""
    from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention_plain, fwd_config, fwd_f32_split)
    from tiny_flash_attention_tpu_torch.utils.testing import fold_q

    def plain(x, sc, vv=v, ids=None):
        return flash_attention_plain(x, k, vv, causal=True, sm_scale=sc,
                                     segment_ids=ids, return_lse=True)

    def dropped(cols):
        kv_ids = torch.zeros((b, kv_len), dtype=torch.int32, device="cuda")
        kv_ids[:, cols] = 1
        q_ids = torch.zeros((b, bm), dtype=torch.int32, device="cuda")
        return plain(qf[:, :, rows], scale, ids=(q_ids, kv_ids))

    b, _, q_len, _ = q.shape
    cfg = fwd_config(q.dtype, head_dim=q.shape[-1])
    kv_len, bm, bn = k.shape[2], cfg.block_m, cfg.block_n
    j = kv_len // bn // 2
    tile, prev = slice(j * bn, (j + 1) * bn), slice((j - 1) * bn, j * bn)
    rows = slice(q_len - bm, q_len)
    qf, scale = fold_q(q, sm_scale)
    stale = v.clone()
    stale[:, :, tile] = v[:, :, prev]
    faults = {f"V of kv tile {j} from tile {j - 1}": plain(
                  qf[:, :, rows], scale, vv=stale),
              f"kv tile {j} dropped": dropped(tile)}
    if q.dtype == torch.float32:
        split = min(fwd_f32_split(q_len, kv_len, causal=True,
                                  n_bh=b * q.shape[1], config=FlashConfig(),
                                  cfg=cfg),
                    kv_len // bn // 2)
        faults[f"run of kv tiles [0, {split}) lost in the merge"] = \
            dropped(slice(0, split * bn))
    gate_faults(f"flash {name}", faults, plain, q, rows)


def gate_faults(name, faults, plain, q, rows) -> None:
    """Each fault's (out, lse) of the rows `rows`, written into the plain
    version's output on the folded q, put through the flash gate of q's
    dtype against `plain`: each must fail it."""
    from tiny_flash_attention_tpu_torch.utils.testing import (
        flash_gate, fold_q)

    for label, (f_out, f_lse) in faults.items():
        out, lse = plain(*fold_q(q, q.shape[-1] ** -0.5))
        out[:, :, rows], lse[:, :, rows] = f_out, f_lse
        errs, folded, ok = flash_gate(out, lse, plain, q, q.dtype)
        log(f"{name}: planted fault in the last q tile's rows, "
            f"{label}: {flash_readings(errs, folded)} "
            f"({gate_text(q.dtype)}) | "
            f"{'PASSES THE GATE' if ok else 'caught'}")
        if ok:
            raise AssertionError(f"the flash gate passes a planted fault: "
                                 f"{name}, {label}")


def v1_planted_faults(name, q, k, v, sm_scale) -> None:
    """Three faults of B14's pipeline (causal, q_len == kv_len), planted in
    the last q tile's rows (the tile of q's dtype, which walks every kv
    tile) of FA1's plain version on the folded q and gated as the kernel's
    output is (bf16: at the fold too; f32: at its dtype gate): (1) kv tile
    j's V from tile j - 1 (a stale K/V ring stage); (2) kv tile j dropped;
    (3) FA1's own fault, the tile's state not reloaded at kv step j, so it
    restarts from zero there and sees kv tiles j.. only; j the middle
    tile. Each is the plain version on cut inputs: the q rows keep their
    positions (the decode offset), and kv tiles before the cut lie left of
    every row's causal edge."""
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        flash_attention_v1_plain, v1_config)
    from tiny_flash_attention_tpu_torch.utils.testing import fold_q

    def plain(x, sc, kk=k, vv=v):
        return flash_attention_v1_plain(x, kk, vv, causal=True, sm_scale=sc)

    q_len, kv_len = q.shape[2], k.shape[2]
    cfg, _ = v1_config(q.dtype, q.shape[-1])
    bm, bn = cfg.block_m, cfg.block_n
    j = kv_len // bn // 2
    tile, prev = slice(j * bn, (j + 1) * bn), slice((j - 1) * bn, j * bn)
    rows = slice(q_len - bm, q_len)
    qf, scale = fold_q(q, sm_scale)
    stale = v.clone()
    stale[:, :, tile] = v[:, :, prev]
    keep = torch.ones(kv_len, dtype=torch.bool, device="cuda")
    keep[tile] = False
    faults = {f"V of kv tile {j} from tile {j - 1}": plain(
                  qf[:, :, rows], scale, vv=stale),
              f"kv tile {j} dropped": plain(
                  qf[:, :, rows], scale, kk=k[:, :, keep], vv=v[:, :, keep]),
              f"state not reloaded at kv step {j}": plain(
                  qf[:, :, rows], scale, kk=k[:, :, j * bn:],
                  vv=v[:, :, j * bn:])}
    gate_faults(f"flash_v1 {name}", faults, plain, q, rows)


def check_flash(name, q_shape, kv_shape, dtype, causal, gen, *, iters=10,
                faults=False):
    """Kernel vs plain on one shape, then the device times of the kernel,
    the plain version and SDPA (cuda_time_ms: L2 cold, no host time) and
    the device kernel SDPA ran (sdpa_kernel_name), in the log and the row.
    With `faults`, also what the gate reads on planted faults
    (planted_faults)."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    q = randn(q_shape, dtype, gen)
    k, v = randn(kv_shape, dtype, gen), randn(kv_shape, dtype, gen)
    sm_scale = 1.0 / q_shape[-1] ** 0.5
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    errs, folded, ok = flash_gate(
        out, lse, lambda qq, sc: flash_attention_plain(
            qq, k, v, causal=causal, sm_scale=sc, return_lse=True), q, dtype)
    ok = ok and bool(torch.isfinite(out).all())
    same = ""
    if dtype == torch.float32:
        # the f32 instance merges its runs in a fixed order
        again = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        bits = all(torch.equal(x, y) for x, y in zip(again, (out, lse)))
        same = f"; two calls bit-identical: {bits}"
        ok = ok and bits
        del again
    if faults:
        planted_faults(name, q, k, v, sm_scale)
    del out, lse
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
    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=sdpa_causal, enable_gqa=True)
    t_sdpa = cuda_time_ms(sdpa, iters=iters)["median_ms"]
    ran = f" ({sdpa_kernel_name(sdpa)})"
    bound_ms, bound_by = flash_bound(q, k, causal)
    log(f"flash {name}: q{tuple(q_shape)} kv{tuple(kv_shape)} "
        f"{str(dtype).split('.')[-1]} causal={causal} | "
        f"{flash_readings(errs, folded)} ({gate_text(dtype)}){same} | "
        f"kernel "
        f"{t_kernel:.4f} ms "
        f"plain {t_plain:.4f} ms sdpa {t_sdpa:.4f} ms{ran} bound "
        f"{bound_ms:.4f} ms "
        f"({bound_by}) | {bound_ms / t_kernel:.1%} of the bound, "
        f"{t_kernel / t_sdpa:.2f}x SDPA | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with plain: {name}")
    row = {"max_abs_err": max(errs["out"], errs["lse"]), "ms": t_kernel,
           "plain_ms": t_plain, "library_ms": t_sdpa, "bound_ms": bound_ms,
           "bound_by": bound_by, "shape": [list(q_shape), list(kv_shape)],
           "library": ran.strip(" ()")}
    return row


def fwd_f32_split_sweep(gen) -> None:
    """B1's f32 instance at the f32 train step's shape for several runs a
    q tile (a FlashConfig's `f32_split`): the blocks and device ms of
    each, each held to the f32 gate against the plain version."""
    from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain, fwd_f32_work)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    q_shape, kv_shape = F32_FWD_SHAPE
    q = randn(q_shape, torch.float32, gen)
    k, v = (randn(kv_shape, torch.float32, gen) for _ in range(2))
    chosen, cells = FlashConfig().f32_split, []
    for split in (1, 2, 3, 4, 5, 6, 8, 16):
        config = FlashConfig(f32_split=split)
        out, lse = flash_attention(q, k, v, causal=True, config=config,
                                   return_lse=True)
        torch.cuda.synchronize()
        errs, _, ok = flash_gate(out, lse, lambda x, sc: (
            flash_attention_plain(x, k, v, causal=True, sm_scale=sc,
                                  return_lse=True)), q, torch.float32)
        if not ok:
            raise AssertionError(f"f32 forward at split {split}: {errs}")
        n_bh = q_shape[0] * q_shape[1]
        blocks = fwd_f32_work(q_shape[2], kv_shape[2], causal=True,
                              n_bh=n_bh, config=config)[1] * n_bh
        t = cuda_time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                 config=config),
                         iters=10)["median_ms"]
        cells.append(f"{split}: {blocks} blocks {t:.4f}")
    log(f"f32 forward split sweep, q{q_shape} kv{kv_shape} causal, runs of "
        f"at most S kv tiles a block (S: blocks, ms): " + "; ".join(cells)
        + f" (chosen: S {chosen})")


# --- phase 3: paged decode, kernel vs plain ----------------------------------


def split_errs(out, lse, plain):
    """(out err, row err, lse err, ok) of a decode against its plain
    version at the kernel's own splits and unsplit: the absolute errors
    are the worst of both, the row error (`row_err`) is against the split
    version; ok when all pass the decode gates."""
    from tiny_flash_attention_tpu_torch.utils.testing import row_err

    ref, ref_lse = plain("kernel")
    whole, whole_lse = plain(None)
    err = max(max_err(out, ref), max_err(out, whole))
    row = row_err(out, ref)
    lse_err = max(max_err(lse, ref_lse), max_err(lse, whole_lse))
    ok = (err <= DECODE_OUT_GATE and row <= DECODE_ROW_GATE
          and lse_err <= DECODE_LSE_GATE and bool(torch.isfinite(out).all()))
    return err, row, lse_err, ok


def spaced_split_errs(out, lse, plain):
    """split_errs with the absolute out gate of the decodes above head_dim
    256 (DECODE_OUT_GATE, earlier runs' readings): an element may differ
    from a plain version by more than DECODE_OUT_GATE by at most one bf16
    ulp of that |plain|, and only where out is a bf16 neighbour (within
    one ulp) of the plain version's f32 out at the kernel's splits before
    its last rounding, plain("kernel", torch.float32): the two roundings
    of one f32 value, not a fault. The row and LSE gates are split_errs'.
    Returns (out err, row err, lse err, the elements past DECODE_OUT_GATE,
    their largest |out - f32 model| over its ulp, ok)."""
    from tiny_flash_attention_tpu_torch.utils.testing import (
        bf16_ulp, row_err)

    ref, ref_lse = plain("kernel")
    whole, whole_lse = plain(None)
    got = out.float()
    over = torch.zeros_like(got, dtype=torch.bool)
    ok = bool(torch.isfinite(out).all())
    for want in (ref.float(), whole.float()):
        e = (got - want).abs()
        over |= e > DECODE_OUT_GATE
        ok = ok and bool((e <= bf16_ulp(want).clamp(
            min=DECODE_OUT_GATE)).all())
    witness = 0.0
    if over.any():
        model = plain("kernel", torch.float32)[0].float()
        witness = float(((got - model).abs() / bf16_ulp(model))[over].max())
        ok = ok and witness <= 1.0
    err = max(max_err(out, ref), max_err(out, whole))
    row = row_err(out, ref)
    lse_err = max(max_err(lse, ref_lse), max_err(lse, whole_lse))
    ok = ok and row <= DECODE_ROW_GATE and lse_err <= DECODE_LSE_GATE
    return err, row, lse_err, int(over.sum()), witness, ok


def gate_readings(err, row, lse_err) -> str:
    return (f"out err {err:.3e} (gate {DECODE_OUT_GATE:.0e}) row "
            f"{row:.3e} (gate {DECODE_ROW_GATE:.4e}, split plain) lse err "
            f"{lse_err:.3e} (gate {DECODE_LSE_GATE:.0e}; split and unsplit "
            f"plain)")


def fault_pages(lengths, table, page_size) -> tuple:
    """(page, page before it) of the planted decode faults: the middle page
    of the longest sequence's attended tokens."""
    seq = int(lengths.argmax())
    n = min(int(lengths[seq]), table.shape[1] * page_size) // page_size
    return int(table[seq, n // 2]), int(table[seq, n // 2 - 1])


def check_v_faults(name, faults, plain) -> None:
    """Planted V-side faults of a decode, put through its gates against the
    sound plain version (`split_errs`): `faults` maps a label to the
    faulted plain version's (out, lse) at the kernel's splits. Each must
    fail."""
    for label, (f_out, f_lse) in faults.items():
        err, row, lse_err, ok = split_errs(f_out, f_lse, plain)
        log(f"decode {name}: planted fault, {label}: "
            f"{gate_readings(err, row, lse_err)} | "
            f"{'PASSES THE GATE' if ok else 'caught'}")
        if ok:
            raise AssertionError(f"the decode gate passes a planted fault: "
                                 f"{name}, {label}")


def b4_faults(q, pages, lengths, table, page_size) -> dict:
    """B4's planted faults in the plain version at the kernel's splits, on
    the middle page of the longest sequence: its V rows of tokens 32-63
    replaced by those of tokens 0-31 (a stale chunk of the bulk-copy
    ring; at a page size under 64, tokens ps/2 to ps by the first ps/2);
    for int8 pages also its V-scale rows replaced by the page before's."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_plain, scale_rows_per_side)

    ps = page_size
    c = min(32, ps // 2)
    page, prev = fault_pages(lengths, table, ps)
    stale = pages.clone()
    stale[:, page, ps + c:ps + 2 * c] = pages[:, page, ps:ps + c]
    bad = {f"V of tokens {c}-{2 * c - 1} of a page from tokens 0-{c - 1}":
           stale}
    if pages.dtype == torch.int8:
        v_scales = 2 * ps + scale_rows_per_side(ps, pages.shape[-1])
        wrong = pages.clone()
        wrong[:, page, v_scales:] = pages[:, prev, v_scales:]
        bad["V-scale rows of a page from the page before"] = wrong
    return {label: fused_paged_decode_plain(
                q, x, lengths, table, page_size=ps,
                sm_scale=q.shape[-1] ** -0.5, splits="kernel")
            for label, x in bad.items()}


def kernel_splits(pages_per_seq, page_size, window=None) -> tuple:
    """(splits launched, pages a split) of a decode by ops/configs.py's
    rule."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import decode_splits

    per, n = decode_splits(pages_per_seq, page_size, window)
    return n, per


def b12_faults(q, k, v, lengths, table) -> dict:
    """B12's planted faults, as b4_faults over separate K and V arrays: a
    stale V chunk (half a page under 64 tokens); for int8 pages also a
    page's V scales from the page before."""
    from tiny_flash_attention_tpu_torch.ops.paged import paged_decode_plain
    from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor

    int8 = isinstance(v, QuantizedTensor)
    vals = v.values if int8 else v
    page, prev = fault_pages(lengths, table, vals.shape[2])
    c = min(32, vals.shape[2] // 2)
    stale = vals.clone()
    stale[:, page, c:2 * c] = vals[:, page, 0:c]
    bad = {f"V of tokens {c}-{2 * c - 1} of a page from tokens 0-{c - 1}":
           QuantizedTensor(values=stale, scales=v.scales) if int8
           else stale}
    if int8:
        wrong = v.scales.clone()
        wrong[:, page] = v.scales[:, prev]
        bad["V scales of a page from the page before"] = QuantizedTensor(
            values=v.values, scales=wrong)
    return {label: paged_decode_plain(q, k, x, lengths, table,
                                      sm_scale=q.shape[-1] ** -0.5,
                                      splits="kernel")
            for label, x in bad.items()}


def check_decode(name, q, pages, lengths, table, page_size, *, iters=20,
                 faults=False):
    """B4 against its plain version at the kernel's split count (the
    same page-aligned partials, merged in order) and unsplit, at the decode
    gates; device times of both and the bound. With `faults`, also what the
    gates read on planted V-side faults (b4_faults)."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_attention, fused_paged_decode_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    sm_scale = 1.0 / q.shape[-1] ** 0.5
    n_splits, per = kernel_splits(table.shape[1], page_size)
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=page_size)
    torch.cuda.synchronize()
    plain = (lambda sp: fused_paged_decode_plain(
        q, pages, lengths, table, page_size=page_size, sm_scale=sm_scale,
        splits=sp))
    err, row, lse_err, ok = split_errs(out, lse, plain)
    if faults:
        check_v_faults(name, b4_faults(q, pages, lengths, table, page_size),
                       plain)
    t_kernel = cuda_time_ms(lambda: fused_paged_decode_attention(
        q, pages, lengths, table, page_size=page_size),
        iters=iters)["median_ms"]
    t_plain = cuda_time_ms(lambda: fused_paged_decode_plain(
        q, pages, lengths, table, page_size=page_size, sm_scale=sm_scale),
        iters=iters)["median_ms"]
    bound_ms, bound_by = decode_bound(q, pages, lengths, table, page_size)
    kv_bytes = bound_ms * 1e-3 * PEAK_BYTES_PER_S
    log(f"decode {name}: q{tuple(q.shape)} pages{tuple(pages.shape)} "
        f"table{tuple(table.shape)} lengths {lengths.tolist()} | {n_splits} "
        f"splits of {per} pages ({n_splits * pages.shape[0] * q.shape[0]} "
        f"blocks) | {gate_readings(err, row, lse_err)} | kernel "
        f"{t_kernel:.4f} ms plain {t_plain:.4f} ms bound {bound_ms:.4f} ms "
        f"({bound_by}) | {kv_bytes / (t_kernel * 1e-3) / 1e9:.1f} GB/s | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode kernel disagrees with plain: {name}")
    return {"max_abs_err": max(err, lse_err), "ms": t_kernel,
            "plain_ms": t_plain, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "splits": n_splits,
            "shape": [list(q.shape), list(pages.shape), list(table.shape)]}


def decode_split_sweep(name, q, pages, lengths, table, page_size) -> None:
    """B4's time by split count at one cache: what ops/configs.py::
    PAGED_DECODE_SPLIT_TOKENS should be (set for each count, then
    restored)."""
    from tiny_flash_attention_tpu_torch.ops import configs
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        decode_splits, fused_paged_decode_attention)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    chosen, per_chosen = kernel_splits(table.shape[1], page_size)
    cells = []
    default = configs.PAGED_DECODE_SPLIT_TOKENS
    try:
        for sp in sorted({1, 4, 8, 16, chosen, 32, 64}):
            per, n = decode_splits(table.shape[1], page_size, None, sp)
            configs.PAGED_DECODE_SPLIT_TOKENS = per * page_size
            t = cuda_time_ms(lambda: fused_paged_decode_attention(
                q, pages, lengths, table, page_size=page_size),
                iters=20)["median_ms"]
            cells.append(f"{n} x {per} pages: {t:.4f}")
    finally:
        configs.PAGED_DECODE_SPLIT_TOKENS = default
    log(f"decode splits {name}, kernel ms: " + "; ".join(cells)
        + f" (chosen: {chosen} x {per_chosen} pages)")


def decode_inputs(gen, *, batch=8, hq=8, hkv=2, d=128, ps=128, P=32,
                  dtype=torch.bfloat16):
    num_pages = batch * P + 8
    q = randn((batch, hq, d), dtype, gen)
    pages = randn((hkv, num_pages, 2 * ps, d), dtype, gen)
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
        flash_attention_bwd, flash_attention_bwd_plain)
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized)
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop)
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        flash_attention_v1)
    from tiny_flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)
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
    k8, v8 = Q.quantize_kv(q, q, "int8")
    no_vjp = {
        "flash_attention(return_lse=True)":
            lambda x: flash_attention(x, q, q, causal=True,
                                      return_lse=True)[0],
        "flash_attention_quantized":
            lambda x: flash_attention_quantized(x, k8, v8, causal=True),
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
    # head dims above 256: f32 (B1, the backward, the decodes:
    # B-dims-2a-f32), the quantized forward and FA1 (B-dims-2a-quant-v1);
    # above 512 every entry (B-dims-2a-512+), the bf16 forward and backward,
    # the decodes and the append included
    def zeros(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, device="cuda", dtype=dtype)

    q264 = zeros(1, 2, 128, 264)
    f264 = zeros(1, 2, 128, 264, dtype=torch.float32)
    q520 = zeros(1, 2, 128, 520)
    f520 = zeros(1, 2, 128, 520, dtype=torch.float32)
    two = torch.zeros(2, dtype=torch.int32, device="cuda")
    attempts += [
        lambda: flash_attention(f264, f264, f264, causal=True),
        lambda: flash_attention_v1(q264, q264, q264),
        lambda: flash_attention_v1(f264, f264, f264),
        lambda: flash_attention_quantized(q264, *Q.quantize_kv(
            q264, q264, "int8")),
        lambda: flash_attention_quantized(f264, *Q.quantize_kv(
            q264, q264, "int8")),
    ]
    qd, pages_d = zeros(2, 6, 264, dtype=torch.float32), zeros(
        2, 4, 32, 264, dtype=torch.float32)
    attempts += [
        lambda: fused_paged_decode_attention(qd, pages_d, lengths, table,
                                             page_size=16),
        lambda: paged_decode_attention(qd, pages_d, pages_d, lengths,
                                       table)]
    n_264 = len(attempts)
    attempts += [
        lambda: flash_attention(q520, q520, q520, causal=True),
        lambda: flash_attention(f520, f520, f520, causal=True),
        lambda: flash_attention_v1(q520, q520, q520),
        lambda: flash_attention_quantized(q520, *Q.quantize_kv(
            q520, q520, "int8")),
        lambda: flash_attention_rowloop(q520, q520, q520, causal=True),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        qd, pages_d = zeros(2, 6, 520, dtype=dtype), zeros(2, 4, 32, 520,
                                                           dtype=dtype)
        attempts += [
            lambda q=qd, p=pages_d: fused_paged_decode_attention(
                q, p, lengths, table, page_size=16),
            lambda q=qd, p=pages_d: paged_decode_attention(
                q, p, p, lengths, table),
            lambda q=qd, p=pages_d: fused_page_append(
                p, q[:, :2], q[:, :2], two, two, page_size=16)]
    for fn in attempts:
        try:
            fn()
        except NotImplementedError:
            continue
        raise AssertionError("a feature this slice does not port ran on "
                             "the card")
    # the backward's refusals name their queues: bf16 above 512
    # (B-dims-2a-512+), f32 above 256 (B-dims-2a-f32)
    for x, queue in ((q520, "B-dims-2a-512+"), (f264, "B-dims-2a-f32")):
        try:
            flash_attention_bwd(x, x, x, x, lse, x, causal=True)
        except NotImplementedError as e:
            if queue not in str(e):
                raise
        else:
            raise AssertionError(f"a {x.dtype} backward at head_dim "
                                 f"{x.shape[-1]} did not raise")
    # a backward() through B1 at head_dim 384 runs (the bf16 backward's
    # instance of width 512), its gradients at the plain backward's gate
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q384, k384, v384, do384 = (randn((1, 2, 128, 384), torch.bfloat16, gen)
                               for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q384, k384, v384)]
    flash_attention(*leaves, causal=True).backward(do384)
    out384, lse384 = flash_attention(q384, k384, v384, causal=True,
                                     return_lse=True)
    want = flash_attention_bwd_plain(q384, k384, v384, out384, lse384, do384,
                                     causal=True, sm_scale=384 ** -0.5)
    err384 = max(_rel_err(t.grad, w) for t, w in zip(leaves, want))
    if not err384 <= BWD_PLAIN_GATE[torch.bfloat16]:
        raise AssertionError(f"a backward through B1 at head_dim 384: "
                             f"{err384:.3e} from the plain backward")
    # int8 fused pages of page size 48 at head_dim 36 (neither <= head_dim
    # nor a multiple of it) raise as JAX's assert does, before any launch
    q36, pages36 = zeros(2, 6, 36), zeros(2, 4, 2 * 48 + 16, 36,
                                          dtype=torch.int8)
    refused = [
        lambda: fused_paged_decode_attention(q36, pages36, lengths, table,
                                             page_size=48),
        lambda: fused_page_append(pages36, q36[:, :2], q36[:, :2], two, two,
                                  page_size=48)]
    for fn in refused:
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError("int8 pages JAX refuses ran on the card")
    log(f"not-ported features raise NotImplementedError on the card: ok "
        f"({len(attempts)}: int8 K/V without scales; at head_dim 264 "
        f"({n_264 - 3} calls) B1 in f32, FA1 (bf16, f32), the quantized "
        f"forward (bf16 q, f32 q), the decodes with f32 q; at head_dim 520 "
        f"({len(attempts) - n_264}) every entry, B1 in bf16, the row loop, "
        f"the decodes and the append included; the backward's refusals "
        f"name their queues, B-dims-2a-512+ (bf16 at 520) and "
        f"B-dims-2a-f32 (f32 at 264)); a backward() "
        f"through B1 at head_dim 384 runs, {err384:.2e} from the plain "
        f"backward (gate {BWD_PLAIN_GATE[torch.bfloat16]:.0e}); int8 fused "
        f"pages at page size 48 and head_dim 36 raise ValueError as JAX "
        f"asserts: ok (the decode, the append)")


# --- the autotuner and the native CPU oracle ---------------------------------

# (label, q shape, kv shape, dtype): the f32 shape of Gemma-2B's prefill and
# train step (PERF.md's S sweep at head_dim 256), Phi-3-mini's (head_dim 96,
# the narrow instance against the 128-wide one), the engine model's prefill
AUTOTUNE_SHAPES = [
    ("f32 Gemma-2B widths", (1, 8, 2048, 256), (1, 1, 2048, 256),
     torch.float32),
    ("bf16 Phi-3-mini widths", (4, 32, 2048, 96), (4, 32, 2048, 96),
     torch.bfloat16),
    ("bf16 engine model", (4, 8, 2048, 128), (4, 2, 2048, 128),
     torch.bfloat16),
]
AUTOTUNE_ROUNDS = 10
AUTOTUNE_F32_GATE = 2e-5     # an f32 run split merges in another order


def autotune_phase(gen) -> dict:
    """utils/autotune.py on the card at AUTOTUNE_SHAPES (causal): every
    candidate's device ms (run_benchmark, min of AUTOTUNE_ROUNDS) and the
    winner; the winner against the plain version at the forward's gates and
    against the call without config (bf16: the same bits; f32: within
    AUTOTUNE_F32_GATE); the memo (a second call returns the same object and
    launches nothing); save_cache and load_cache in a temporary directory.
    Then default_config passed explicitly gives the bits of a call without
    config: B1 bf16 and f32, the quantized forward (bf16 and f32 q over
    int8) and B11's jagged mode. Returns {label: (winner, timings)}."""
    import os
    import tempfile

    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.configs import default_config
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized)
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop)
    from tiny_flash_attention_tpu_torch.utils import autotune as AT
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    t0 = time.perf_counter()
    AT._CACHE.clear()
    results, ok = {}, True
    for label, q_shape, kv_shape, dtype in AUTOTUNE_SHAPES:
        q = randn(q_shape, dtype, gen)
        k, v = randn(kv_shape, dtype, gen), randn(kv_shape, dtype, gen)
        base = flash_attention(q, k, v, causal=True)
        win = AT.autotune_flash_config(q, k, v, causal=True,
                                       rounds=AUTOTUNE_ROUNDS)
        timings = [(c, r["min_ms"], r["median_ms"])
                   for c, r in AT.last_timings]
        launches = flash_attention.launches
        memo = AT.autotune_flash_config(q, k, v, causal=True) is win \
            and flash_attention.launches == launches
        out, lse = flash_attention(q, k, v, causal=True, config=win,
                                   return_lse=True)
        errs, folded, gate = flash_gate(
            out, lse, lambda qq, sc: flash_attention_plain(
                qq, k, v, causal=True, sm_scale=sc, return_lse=True), q,
            dtype)
        if dtype == torch.bfloat16:
            vs_default, same = 0.0, bool(torch.equal(out, base))
        else:
            vs_default = max_err(out, base)
            same = vs_default <= AUTOTUNE_F32_GATE
        row_ok = gate and same and memo
        ok = ok and row_ok
        cands = "; ".join(
            f"{_config_text(c)}: {mn:.4f} ms (median {md:.4f})"
            for c, mn, md in timings)
        is_default = win == default_config(dtype, q_shape[3], q_shape[2],
                                           kv_shape[2])
        log(f"autotune {label}: q{q_shape} kv{kv_shape} causal | "
            f"{len(timings)} candidates: {cands} | winner "
            f"{_config_text(win)} ("
            f"{'the default' if is_default else 'NOT the default'}) | "
            f"winner vs plain: {flash_readings(errs, folded)} "
            f"({gate_text(dtype)}); vs the call without config: "
            + ("bits equal " + str(same) if dtype == torch.bfloat16 else
               f"{vs_default:.3e} (gate {AUTOTUNE_F32_GATE:.0e})")
            + f"; memoized, nothing launched: {memo} | "
            f"{'ok' if row_ok else 'FAIL'}")
        results[label] = (win, timings)
        del q, k, v, base, out, lse
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tune.json")
        AT.save_cache(path)
        kept = dict(AT._CACHE)
        AT._CACHE.clear()
        n = AT.load_cache(path)
        cache_ok = n == len(AUTOTUNE_SHAPES) and AT._CACHE == kept
    log(f"autotune cache: saved and loaded {n} winners, the same: {cache_ok}")
    ok = ok and cache_ok

    # default_config passed explicitly: the bits of a call without config
    same = {}
    for label, q_shape, kv_shape, dtype in AUTOTUNE_SHAPES[::2]:
        q = randn(q_shape, dtype, gen)
        k, v = randn(kv_shape, dtype, gen), randn(kv_shape, dtype, gen)
        cfg = default_config(dtype, q_shape[3], q_shape[2], kv_shape[2])
        name = "B1 " + str(dtype).split(".")[-1]
        same[name] = all(torch.equal(a, b) for a, b in zip(
            flash_attention(q, k, v, causal=True, return_lse=True),
            flash_attention(q, k, v, causal=True, config=cfg,
                            return_lse=True)))
        kq, vq = Q.quantize_kv(k.to(torch.bfloat16), v.to(torch.bfloat16),
                               "int8")
        same[f"quantized, {str(dtype).split('.')[-1]} q over int8"] = \
            torch.equal(flash_attention_quantized(q, kq, vq, causal=True),
                        flash_attention_quantized(q, kq, vq, causal=True,
                                                  config=cfg))
        if dtype == torch.bfloat16:
            lens = torch.tensor([2048, 1000, 513, 7][:q_shape[0]],
                                dtype=torch.int32, device="cuda")
            same["B11 jagged"] = all(torch.equal(a, b) for a, b in zip(
                flash_attention_rowloop(q, k, v, causal=True,
                                        seq_lengths=lens),
                flash_attention_rowloop(q, k, v, causal=True,
                                        seq_lengths=lens, config=cfg)))
        del q, k, v, kq, vq
    log(f"default_config passed explicitly gives the bits of a call without "
        f"config: {same} | {'ok' if all(same.values()) else 'FAIL'}")
    ok = ok and all(same.values())
    log(f"autotune phase: {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError("autotune phase failed")
    AT._CACHE.clear()
    return results


def _config_text(cfg) -> str:
    """A FlashConfig's fields that differ from FlashConfig()."""
    from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig

    base = FlashConfig()
    diff = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(base, f.name)}
    return ("default" if not diff else
            ", ".join(f"{k}={v}" for k, v in diff.items()))


CPU_ORACLE_SHAPE = ((1, 8, 512, 128), (1, 2, 512, 128))
# the oracle's gates against the port's plain reference (the JAX test's)
CPU_ORACLE_GATES = {"naive_attn": 1e-5, "flash_attn": 1e-5,
                    "flash_attn_bf16": 2e-2, "flash_attn_fp16": 1e-2}


def cpu_oracle_phase(gen) -> dict:
    """cpu.py on the host of the card: its library built from
    cpp/attn.cpp, then the four oracle functions at CPU_ORACLE_SHAPE,
    causal and not, against the port's plain reference (mha_reference's
    naive rung) at the JAX test's gates and against B1's output on the
    card copied back (the same inputs in the function's dtype; f32 at
    2e-5, bf16 and fp16 at their reference gates). Prints simd_width and
    the host seconds."""
    from tiny_flash_attention_tpu_torch import cpu
    from tiny_flash_attention_tpu_torch.ops import reference as R
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention

    t0 = time.perf_counter()
    path = cpu.build()
    build_s = time.perf_counter() - t0
    dtypes = {"naive_attn": torch.float32, "flash_attn": torch.float32,
              "flash_attn_bf16": torch.bfloat16,
              "flash_attn_fp16": torch.float16}
    q_shape, kv_shape = CPU_ORACLE_SHAPE
    q = randn(q_shape, torch.float32, gen)
    k, v = randn(kv_shape, torch.float32, gen), randn(kv_shape,
                                                      torch.float32, gen)
    readings, ok = [], True
    for causal in (False, True):
        for name, dtype in dtypes.items():
            qh, kh, vh = (x.to(dtype).cpu() for x in (q, k, v))
            t1 = time.perf_counter()
            got = getattr(cpu, name)(qh, kh, vh, causal=causal)
            host_s = time.perf_counter() - t1
            plain = R.mha_reference(qh, kh, vh, causal=causal,
                                    impl=R.attention_naive)
            card = flash_attention(*(x.to(dtype) for x in (q, k, v)),
                                   causal=causal).cpu()
            e_plain, e_card = max_err(got, plain), max_err(got, card)
            gate = CPU_ORACLE_GATES[name]
            card_gate = 2e-5 if dtype == torch.float32 else gate
            good = (got.dtype == dtype and e_plain <= gate
                    and e_card <= card_gate)
            ok = ok and good
            readings.append(f"{name} causal={causal}: {host_s:.4f} s, vs "
                            f"plain {e_plain:.2e} (gate {gate:.0e}), vs B1 "
                            f"on the card {e_card:.2e} (gate "
                            f"{card_gate:.0e}){'' if good else ' FAIL'}")
    try:
        cpu.naive_attn(q, k, v)
        refused = False
    except ValueError:
        refused = True
    ok = ok and refused
    log(f"cpu oracle: {path.name} built from cpp/attn.cpp in {build_s:.2f} "
        f"s (host compiler), simd_width {cpu.simd_width()}, "
        f"q{q_shape} kv{kv_shape} | " + "; ".join(readings)
        + f" | a CUDA tensor refused (ValueError): {refused} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cpu oracle phase failed")
    return {"build_s": build_s}


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


def append_inputs(gen, *, fmt, ps, batch=8, hkv=2, d=128, P=32,
                  dtype=torch.bfloat16):
    """Pages of `fmt` ("bf16": of the rows' dtype) and the rows of 8
    tokens in `dtype`, random targets."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import page_rows

    num_pages = batch * P + 8
    shape = (hkv, num_pages, page_rows(ps, d, fmt), d)
    if fmt == "int8":
        pages = torch.randint(-127, 128, shape, generator=gen,
                              device="cuda").to(torch.int8)
    else:
        pages = randn(shape, dtype, gen)
    k_new = randn((batch, hkv, d), dtype, gen)
    v_new = randn((batch, hkv, d), dtype, gen)
    ids = torch.randperm(num_pages, generator=gen, device="cuda")[:batch]
    rows = torch.randint(0, ps, (batch,), generator=gen, device="cuda")
    return pages, k_new, v_new, ids.to(torch.int32), rows.to(torch.int32)


def check_append(name, fmt, ps, gen, *, iters=20, d=128, hkv=2,
                 dtype=torch.bfloat16):
    """The append kernel vs its plain version (the scatter decomposition),
    bit for bit, rows in `dtype`; device times of both. The bound: the new
    rows read once, the page rows and scale bytes written once."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, page_append_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    pages, k_new, v_new, ids, rows = append_inputs(gen, fmt=fmt, ps=ps, d=d,
                                                   hkv=hkv, dtype=dtype)
    base = pages.clone()
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
    t_lib = None
    if fmt == "bf16":
        # one PyTorch call does the append into pages of the rows' dtype:
        # index_put_ of the K and V rows at their (kv head, page, row)
        # positions, the indices and values laid out beforehand (int8
        # pages have no such call: the quantization and the scale bytes
        # are passes of their own)
        batch, hkv, _ = k_new.shape
        pos = torch.cat([rows, rows + ps]).long()
        idx = (torch.arange(hkv, device="cuda")[:, None].expand(
                   hkv, 2 * batch),
               torch.cat([ids, ids]).long()[None].expand(hkv, 2 * batch),
               pos[None].expand(hkv, 2 * batch))
        vals = torch.cat([k_new, v_new]).transpose(0, 1).contiguous()
        base.index_put_(idx, vals)
        if not torch.equal(base, want):
            raise AssertionError(f"index_put_ append differs: {name}")
        t_lib = cuda_time_ms(lambda: base.index_put_(idx, vals),
                             iters=iters)["median_ms"]
    h_kernel = host_us(lambda: fused_page_append(
        pages, k_new, v_new, ids, rows, page_size=ps))
    h_plain = host_us(lambda: page_append_plain(
        pages, k_new, v_new, ids, rows, page_size=ps))
    floor = launch_floor_ms(iters)
    batch, hkv, d = k_new.shape
    row_bytes = d * pages.element_size() + (4 if fmt == "int8" else 0)
    nbytes = (2 * k_new.numel() * k_new.element_size() + 8 * batch
              + 2 * batch * hkv * row_bytes)
    bound_ms, bound_by = _bound(0.0, nbytes, dtype)
    log(f"page append {name}: {fmt} pages{tuple(pages.shape)} "
        f"{str(pages.dtype).split('.')[-1]} ps {ps}, "
        f"{batch} tokens x {hkv} kv heads | bit-exact vs plain: {ok} | "
        f"kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms"
        + (f" index_put_ {t_lib:.4f} ms" if t_lib is not None else "")
        + f" bound {bound_ms:.6f} ms ({bound_by}); launch floor (a "
        f"one-element add_) {floor:.4f} ms, kernel {t_kernel / floor:.2f}x "
        f"it | host {h_kernel:.1f} us a call, plain {h_plain:.1f} us | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"append kernel disagrees with plain: {name}")
    return {"max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
            "library_ms": t_lib, "bound_ms": bound_ms, "bound_by": bound_by,
            "floor_ms": floor}


def launch_floor_ms(iters: int = 20) -> float:
    """The least time any launch reads under cuda_time_ms: a one-element
    add_ (its L2 flushed like every timed call's)."""
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    one = torch.zeros(1, device="cuda")
    return cuda_time_ms(lambda: one.add_(1.0), iters=iters)["median_ms"]


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


def bwd_f32_split_sweep(gen) -> None:
    """The f32 backward at the f32 train step's shape (the first f32 row of
    BWD_CASES) for several runs a tile (ops/configs.py::
    FLASH_BWD_F32_SPLIT, read at each call): device ms of the call and of
    each kernel, each split held to the plain gate; the setting is
    restored."""
    from tiny_flash_attention_tpu_torch.ops import configs
    from tiny_flash_attention_tpu_torch.ops import flash_bwd as FB
    from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    name, q_shape, kv_shape, dtype, causal, _ = next(
        c for c in BWD_CASES if c[3] == torch.float32)
    q = randn(q_shape, dtype, gen)
    k, v = randn(kv_shape, dtype, gen), randn(kv_shape, dtype, gen)
    do = randn(q_shape, dtype, gen)
    sc = q_shape[-1] ** -0.5
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    plain = FB.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, sm_scale=sc)
    chosen, cells = configs.FLASH_BWD_F32_SPLIT, []
    try:
        for split in (1, 2, 3, 4, 6, 8, 16):
            configs.FLASH_BWD_F32_SPLIT = split
            call = FB.BwdLaunch(q, k, v, out, lse, do, causal=causal,
                                sm_scale=sc, config=FlashConfig())
            call.run()
            torch.cuda.synchronize()
            err = max(_rel_err(g, w) for g, w in zip(call.grads, plain))
            if not err <= BWD_PLAIN_GATE[dtype]:
                raise AssertionError(f"f32 backward at split {split}: "
                                     f"{err:.3e}")
            t = {part: cuda_time_ms(lambda s=s: call.run(s),
                                    iters=10)["median_ms"]
                 for part, s in (("call", 7), ("dq", 1), ("dkv", 2),
                                 ("post", 4))}
            cells.append(f"{split}: " + "/".join(f"{x:.4f}"
                                                 for x in t.values()))
            del call
    finally:
        configs.FLASH_BWD_F32_SPLIT = chosen
    log(f"f32 backward split sweep, {name}, runs of at most S tiles a "
        f"block (S: call/dq/dkv/post ms): " + "; ".join(cells)
        + f" (chosen: S {chosen})")


def _rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


BWD_SPREAD_PAIRS = 10


def bwd_spread(gate: bool = True, d: int = 128) -> None:
    """The bf16 backward's run-to-run spread (ROADMAP C2): on the inputs of
    tests/test_torch_cuda.py::test_bwd_two_runs_agree_within_one_ulp (seed
    0), BWD_SPREAD_PAIRS pairs of backward runs from the kernel forward's
    out and LSE and as many from the plain forward's: how many pairs differ
    in any bit, how many by more than one bf16 ulp of the larger value
    somewhere, and the element that differs most relative to its size. The
    sums run in an order fixed by the shape and the masks, so with `gate`
    any pair that differs in a bit fails (--bwd-spread only reads). `d`:
    the head_dim (256: the wide instance)."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd)

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16) for s in ((2, 8, 1000, d), (2, 2, 1000, d),
                                  (2, 2, 1000, d), (2, 8, 1000, d)))
    forwards = {
        "kernel forward": flash_attention(q, k, v, causal=True,
                                          return_lse=True),
        "plain forward": flash_attention_plain(q, k, v, causal=True,
                                               sm_scale=d ** -0.5,
                                               return_lse=True)}
    differ_all = 0
    for label, (out, lse) in forwards.items():
        beyond, differ, worst = 0, 0, (0.0, "none")
        for _ in range(BWD_SPREAD_PAIRS):
            one = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
            two = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
            torch.cuda.synchronize()
            pair_beyond = pair_differs = False
            for name, a, b in zip(("dq", "dk", "dv"), one, two):
                pair_differs |= not torch.equal(a, b)
                a, b = a.float(), b.float()
                big = torch.maximum(a.abs(), b.abs())
                pair_beyond |= bool(((a - b).abs() > big * 2.0 ** -7).any())
                rel = torch.where(a == b, 0.0, (a - b).abs() / big)
                at = int(rel.argmax())
                if float(rel.flatten()[at]) > worst[0]:
                    idx = tuple(int(x) for x in np.unravel_index(at, a.shape))
                    worst = (float(rel.flatten()[at]),
                             f"{name}{list(idx)} {float(a[idx]):.4e} vs "
                             f"{float(b[idx]):.4e} (max |{name}| "
                             f"{float(big.max()):.4e})")
            beyond += pair_beyond
            differ += pair_differs
        differ_all += differ
        log(f"bwd spread, head_dim {d}, {label}: {differ}/{BWD_SPREAD_PAIRS} "
            f"pairs of runs "
            f"differ in any bit, {beyond}/{BWD_SPREAD_PAIRS} by more than one "
            f"bf16 ulp somewhere; the largest relative difference "
            f"{worst[0]:.3e}, at {worst[1]}"
            + (f" | {'ok' if differ == 0 else 'FAIL'}" if gate else ""))
    if gate and differ_all:
        raise AssertionError("two runs of the bf16 backward differ: its sums "
                             "are not in a fixed order")


def check_bwd(name, q_shape, kv_shape, dtype, causal, masks, gen, *,
              iters=10, repeats=1, faults=False):
    """The backward kernels vs their plain version and vs autograd through
    the f32 plain forward on one shape, with its masks ("window"; "mix":
    the jagged mix's ids; "bounds": ids changing at those rows; "starts":
    the ids' segment_starts); then the device times of the whole backward
    call, of each kernel alone (bf16: prep, main, post; f32: dq, dk/dv,
    post), of the plain version and of SDPA's backward (with a boolean mask
    where the masks are more than causal; above head_dim 256, where SDPA
    has no flash kernel, with K and V repeated to q's heads, its backend
    named). f32: `repeats` more calls on the same inputs must give the same
    bits. `faults` (bf16, a head_dim read in place off its tile's width):
    the plain backward at the tile's scale and the gradients as an
    epilogue storing all the tile's columns would leave them must fail the
    plain gate."""
    from tiny_flash_attention_tpu_torch.models.engine import pack_prompts
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain, visible_mask)
    from tiny_flash_attention_tpu_torch.ops import flash_bwd as FB
    from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
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
    if masks.get("bounds"):
        seg = segment_ids(q_shape[0], q_shape[2], masks["bounds"])
        ids, offs = seg.cpu().numpy(), (0, *masks["bounds"])
        mk["segment_ids"] = (seg, seg)
    kw = dict(mk, segment_starts=offs if masks.get("starts") else None)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True, **mk)
    got = FB.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, **kw)
    same = True
    for _ in range(repeats if dtype == torch.float32 else 0):
        # the f32 sums run in a fixed order
        again = FB.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       **kw)
        same &= all(torch.equal(a, b) for a, b in zip(got, again))
        del again
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
    ok = (finite and same and max(err_plain) <= BWD_PLAIN_GATE[dtype]
          and max(err_oracle) <= BWD_ORACLE_GATE[dtype])
    if faults:
        bwd_planted_faults(name, q, k, v, out, lse, do, got, causal, mk)

    # each kernel alone, on the tensors the call hands them (padded only
    # where the kernels do not read the head_dim in place; the bound stays
    # at the true head_dim)
    from tiny_flash_attention_tpu_torch.ops.dims import (
        flash_head_dim, pad_head_dim)
    dk = flash_head_dim(q_shape[-1], dtype, "the CUDA backward kernels")
    call = FB.BwdLaunch(*(pad_head_dim(t, dk) for t in (q, k, v, out)), lse,
                        pad_head_dim(do, dk), causal=causal,
                        sm_scale=sm_scale, config=FlashConfig(), **kw)
    stages = ({"prep": 1, "main": 2, "post": 4} if dtype == torch.bfloat16
              else {"dq": 1, "dkv": 2, "post": 4})
    # the f32 post reads the kernels' slots (items x q heads of 64 rows)
    slot_bytes = (sum(x.numel() for x in call.slots) * 4
                  if dtype == torch.float32 else None)
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
    expand = q_shape[-1] > 256
    rep = q_shape[1] // kv_shape[1] if expand else 1
    sq = q.detach().requires_grad_()
    sk, sv = ((t.repeat_interleave(rep, 1) if expand else t).detach()
              .requires_grad_() for t in (k, v))
    s_out = F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=not expand)

    def sdpa_bwd():
        return torch.autograd.grad(s_out, (sq, sk, sv), do, retain_graph=True)

    t_sdpa = cuda_time_ms(sdpa_bwd, iters=iters)["median_ms"]
    sdpa_ran = sdpa_kernel_name(sdpa_bwd) if expand else None
    del s_out, mask, sq, sk, sv
    pairs = mask_pairs(q, k, causal, masks.get("window"), ids)
    bounds = {part: bwd_bound(q, k, part, pairs)
              for part in ("all", *stages)}
    if slot_bytes is not None:
        bounds["post"] = _bound(0.0, slot_bytes + (q.numel() + 2 * k.numel())
                                * 4, dtype)
    log(f"flash bwd {name}: q{tuple(q_shape)} kv{tuple(kv_shape)} "
        f"{str(dtype).split('.')[-1]} causal={causal} | dq/dk/dv err vs "
        f"plain {err_plain[0]:.2e}/{err_plain[1]:.2e}/{err_plain[2]:.2e} "
        f"(gate {BWD_PLAIN_GATE[dtype]:.0e}), vs f32 autograd "
        f"{err_oracle[0]:.2e}/{err_oracle[1]:.2e}/{err_oracle[2]:.2e} "
        f"(gate {BWD_ORACLE_GATE[dtype]:.0e}) of max |grad| | call "
        f"{t_call:.4f} ms ("
        + ", ".join(f"{p} {t:.4f}" for p, t in t_part.items())
        + f") plain {t_plain:.4f} ms sdpa bwd {t_sdpa:.4f} ms"
        + (f" (K/V repeated to {q_shape[1]} heads, {sdpa_ran})"
           if expand else "") + " bound "
        f"{bounds['all'][0]:.4f} ms ({bounds['all'][1]}; "
        + ", ".join(f"{p} {bounds[p][0]:.4f}" for p in stages)
        + f") | {bounds['all'][0] / t_call:.1%} of the bound, "
        f"{t_call / t_sdpa:.2f}x SDPA"
        + ("" if dtype == torch.bfloat16 else
           f" | {repeats + 1} calls bit-identical: {same}")
        + f" | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash backward kernels disagree: {name}")
    return {"max_abs_err": abs_err, "ms": t_part, "call_ms": t_call,
            "plain_ms": t_plain, "library_ms": t_sdpa, "bound": bounds,
            "library": sdpa_ran}


def bwd_planted_faults(name, q, k, v, out, lse, do, got, causal, mk):
    """Two faults of the bf16 backward at a head_dim d read in place on
    the instance of tile width w (the next of 64, 128, 256, 512): the
    plain backward at sm_scale 1/sqrt(w) (a default scale taken after the
    padding), and the kernels' dq, dk, dv as an epilogue that stored all w
    columns of each row at stride d would leave them
    (all_columns_epilogue). Each must fail check_bwd's plain gate."""
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd_plain)

    d = q.shape[-1]
    tile = next(w for w in (64, 128, 256, 512) if d <= w)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                      sm_scale=d ** -0.5, **mk)
    faults = {
        f"sm_scale 1/sqrt({tile})": flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal=causal, sm_scale=tile ** -0.5,
            **mk),
        f"an epilogue storing all {tile} columns at stride {d}": [
            all_columns_epilogue(g, tile) for g in got]}
    for label, grads in faults.items():
        err = max(_rel_err(g, w) for g, w in zip(grads, plain))
        caught = err > BWD_PLAIN_GATE[q.dtype]
        log(f"flash bwd {name}: planted fault, {label}: dq/dk/dv err vs "
            f"plain {err:.2e} of max |grad| (gate "
            f"{BWD_PLAIN_GATE[q.dtype]:.0e}) | "
            f"{'caught' if caught else 'PASSES THE GATE'}")
        if not caught:
            raise AssertionError(f"the backward gate passes a planted "
                                 f"fault: {label}")


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
                   lambda: eng.steps(PROFILE_STEPS), PROFILE_STEPS,
                   STEP_LAUNCHES[label.split(", prompt")[0]])
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
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    b, hq, n, d = q_shape
    q = randn(q_shape, dtype, gen)
    k, v = (randn((b, 2, n, d), dtype, gen) for _ in range(2))
    seg = segment_ids(b, n, bounds)
    q_seg = seg.clone()
    q_seg[-1, n // 2] = 99                   # matches no kv column
    out, lse = flash_attention(q, k, v, causal=causal,
                               segment_ids=(q_seg, seg), return_lse=True)
    torch.cuda.synchronize()
    errs, folded, ok = flash_gate(
        out, lse, lambda qq, sc: flash_attention_plain(
            qq, k, v, causal=causal, sm_scale=sc, segment_ids=(q_seg, seg),
            return_lse=True), q, dtype)
    empty = bool((out[-1, :, n // 2] == 0).all())
    pruned = flash_attention(q, k, v, causal=causal, segment_ids=(seg, seg),
                             segment_starts=(0, *bounds), return_lse=True)
    full = flash_attention(q, k, v, causal=causal, segment_ids=(seg, seg),
                           return_lse=True)
    same = all(torch.equal(x, y) for x, y in zip(pruned, full))
    ok = ok and empty and same
    log(f"flash segments {name}: q{tuple(q_shape)} bounds {bounds} causal="
        f"{causal} | {flash_readings(errs, folded)} ({gate_text(dtype)}) | "
        f"unmatched row empty: {empty} | segment_starts bit-equal to none: "
        f"{same} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"segment kernel disagrees: {name}")
    return max(errs["out"], errs["lse"])


def check_rows(name, out, lse, plain, q, lens) -> dict:
    """Rows below each length within the flash gate (utils/testing.py::
    flash_gate against plain(q', sm_scale)), rows at or past it exactly 0
    with the plain version's sentinel LSE. Returns the readings: {"errs",
    "folded"}."""
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    ref, ref_lse = plain(q, q.shape[-1] ** -0.5)
    for bi, L in enumerate(lens):
        past_ok = (bool((out[bi, :, L:] == 0).all())
                   and torch.allclose(lse[bi, :, L:], ref_lse[bi, :, L:],
                                      rtol=1e-6, atol=0.0))
        if not past_ok:
            raise AssertionError(f"{name}: row {bi} past its length {L} is "
                                 "not an empty row")
    del ref, ref_lse
    errs, folded, ok = flash_gate(out, lse, plain, q, q.dtype, lens)
    if not ok:
        raise AssertionError(f"{name}: {flash_readings(errs, folded)} "
                             f"({gate_text(q.dtype)})")
    return {"errs": errs, "folded": folded}


def check_rowloop(gen, d=128, dtypes=(torch.bfloat16, torch.float32)
                  ) -> float:
    """B11 against its plain version at head_dim d: jagged lengths around
    one tile and the whole row, in each of `dtypes`; then without lengths,
    non-causal and with a decode offset."""
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop, flash_attention_rowloop_plain)

    n = 1024
    lens = [1, 63, 64, 65, n]
    worst = 0.0
    for dtype in dtypes:
        q = randn((5, 8, n, d), dtype, gen)
        k, v = (randn((5, 2, n, d), dtype, gen) for _ in range(2))
        cases = [("jagged", q, True, lens), ("non-causal", q, False, None),
                 ("decode offset q128", q[:, :, -128:], True, None)]
        for label, qq, causal, ln in cases:
            lt = None if ln is None else torch.tensor(ln, device="cuda")
            out, lse = flash_attention_rowloop(qq, k, v, causal=causal,
                                               seq_lengths=lt)
            torch.cuda.synchronize()
            got = check_rows(
                f"rowloop {label}", out, lse,
                lambda x, sc, c=causal, lt=lt: flash_attention_rowloop_plain(
                    x, k, v, causal=c, sm_scale=sc, seq_lengths=lt),
                qq, ln or [qq.shape[2]] * 5)
            errs = got["errs"]
            worst = max(worst, errs["out"], errs["lse"])
            log(f"rowloop {label} {str(dtype).split('.')[-1]}: q"
                f"{tuple(qq.shape)} kv{tuple(k.shape)} lengths {ln} | "
                f"{flash_readings(errs, got['folded'])} ({gate_text(dtype)}) "
                f"on rows below each length; rows past it 0 with the "
                f"sentinel LSE | ok")
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
    (on rows below `valid_lens` where given; plain(q', sm_scale) takes the
    q and scale to use, q and head_dim ** -0.5 by default), then the device
    times of the kernel, the plain version and SDPA with a boolean mask
    (the library yardstick, which the port never calls)."""
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    out, lse = kernel()
    torch.cuda.synchronize()
    lens = valid_lens or [q.shape[2]] * q.shape[0]
    got = check_rows(name, out, lse, plain, q, lens)
    errs = got["errs"]
    del out, lse
    t_kernel = cuda_time_ms(kernel, iters=iters)["median_ms"]
    t_plain = cuda_time_ms(plain, iters=2)["median_ms"]

    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, is_causal=sdpa_causal,
            enable_gqa=True)
    t_sdpa = cuda_time_ms(sdpa, iters=iters)["median_ms"]
    backend = sdpa_kernel_name(sdpa)
    bound_ms, bound_by = bound
    log(f"{name}: q{tuple(q.shape)} kv{tuple(k.shape)} | "
        f"{flash_readings(errs, got['folded'])} ({gate_text(q.dtype)}) | "
        f"kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms sdpa "
        f"{t_sdpa:.4f} ms ({backend}) bound {bound_ms:.4f} ms ({bound_by}) "
        f"| {bound_ms / t_kernel:.1%} of the bound, {t_kernel / t_sdpa:.2f}x "
        f"SDPA | ok")
    return {"max_abs_err": max(errs["out"], errs["lse"]), "ms": t_kernel,
            "plain_ms": t_plain, "library_ms": t_sdpa, "bound_ms": bound_ms,
            "bound_by": bound_by}


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
    tiles = segment_tiles(offs, n, causal=True, device="cuda")
    same = seg[0][:, None] == seg[0][None, :]
    mask = (same & torch.ones_like(same).tril())[None, None]
    bound = ragged_bound(q, k, id_pairs(segs, True), int_bytes=2 * n * 4)
    for label, starts in (("with", tiles), ("without", None)):
        rows[f"packed {label}"] = time_masked(
            f"B1 packed row of the mix, {label} segment_starts", q, k, v,
            kernel=lambda st=starts: flash_attention(
                q, k, v, causal=True, segment_ids=(seg, seg),
                segment_starts=st, return_lse=True),
            plain=lambda x=q, s=sc: flash_attention_plain(
                x, k, v, causal=True, sm_scale=s, segment_ids=(seg, seg),
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
        plain=lambda x=q, s=sc: flash_attention_plain(
            x, k, v, causal=False, sm_scale=s, segment_ids=(eseg, eseg),
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
        plain=lambda x=q, s=sc: flash_attention_rowloop_plain(
            x, k, v, causal=True, sm_scale=s, seq_lengths=lt),
        sdpa_mask=jmask, sdpa_causal=False, valid_lens=JAGGED_MIX,
        bound=ragged_bound(q, k, pairs, tokens=sum(JAGGED_MIX),
                           int_bytes=8 * 4))
    del jmask
    rows["padded"] = time_masked(
        "B1 the mix padded to 8 x 4096", q, k, v,
        kernel=lambda: flash_attention(q, k, v, causal=True,
                                       return_lse=True),
        plain=lambda x=q, s=sc: flash_attention_plain(
            x, k, v, causal=True, sm_scale=s, return_lse=True),
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


def admission_logits(label, cfg, params, prompts, ps, eng=None):
    """The prefill an admission mode runs, on the same inputs, at each
    request's last prompt row: (B, V) f32. With `eng`, through the
    engine's own prefill hooks (the sharded engine's tensor-parallel
    prefills); else models/inference.py's on cfg and params."""
    from tiny_flash_attention_tpu_torch.models import inference as I
    from tiny_flash_attention_tpu_torch.models.engine import (
        pack_prompts, pad_prompts)

    def dev(a):
        return torch.as_tensor(a, device=eng.device)

    if eng is None:
        eng = types.SimpleNamespace(
            device=torch.device("cuda"),
            _prefill=lambda t: I.prefill_forward_batched(cfg, params, t),
            _prefill_packed=lambda t, s, p, o: I.prefill_forward_packed(
                cfg, params, t, s, p, segment_starts=o),
            _prefill_jagged=lambda t, n: I.prefill_forward_jagged(
                cfg, params, t, n))
    last = [len(p) - 1 for p in prompts]
    rows = dev(np.arange(len(prompts)))
    if label.startswith("packed"):
        toks, segs, pos, offs = pack_prompts(prompts, ps, label.split()[1])
        logits = eng._prefill_packed(dev(toks), dev(segs), dev(pos),
                                     tuple(offs))[0]
        return logits[0, dev([o + x for o, x in zip(offs, last)])]
    toks = dev(pad_prompts(prompts, ps))
    if label == "jagged":
        logits = eng._prefill_jagged(
            toks, dev(np.asarray([len(p) for p in prompts], np.int32)))[0]
    else:
        logits = eng._prefill(toks)[0]
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


def train_f32_profile(seed: int) -> int:
    """The f32 train step at TRAIN_F32's shape (the engine model in f32),
    one warm-up step, then where one step's time goes (profile_window)."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.parallel.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {gpu_info()}")
    batch, seq, _ = TRAIN_F32
    cfg = dataclasses.replace(engine_config(), dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step, init_state = make_train_step(cfg, learning_rate=1e-3)
    params, opt = init_state(T.init_params(cfg, gen, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    step(params, opt, tokens)                    # warm-up
    for _ in range(2):
        profile_window(f"per train step of f32 {batch} x {seq} tokens",
                       lambda: step(params, opt, tokens), 1,
                       watch="flash_fwd_f32")
    return 0


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
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    losses = []
    for _ in range(n_steps):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    out["launches"]["flash_fwd_f32"] = flash_attention.launches
    out["launches"]["flash_bwd_f32"] = flash_attention_bwd.launches
    shown = " ".join(f"{x:.4f}" for x in losses)
    log(f"train f32 {batch} x {seq}: loss {shown}; "
        f"{flash_attention.launches} forward and "
        f"{flash_attention_bwd.launches} backward calls (expected "
        f"{n_steps * cfg.n_layers} each: the f32 forward once, the f32 dq, "
        f"dk/dv and post kernels once each)")
    if (flash_attention.launches, flash_attention_bwd.launches) != (
            n_steps * cfg.n_layers, n_steps * cfg.n_layers) or not (
            np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"f32 train step: launches "
                             f"{flash_attention.launches}, "
                             f"{flash_attention_bwd.launches}, {losses}")
    out["states"][f"f32 {batch} x {seq}"] = (step, params, opt, tokens)

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
               P=64, dtype=torch.bfloat16):
    """q, K and V page arrays in `dtype` (int8 QuantizedTensors made from
    such pages by the port's quantizer), lengths and a random page table."""
    from tiny_flash_attention_tpu_torch.ops.quant import quantize_int8

    num_pages = batch * P + 7
    q = randn((batch, hq, d), dtype, gen)
    k, v = (randn((hkv, num_pages, ps, d), dtype, gen) for _ in range(2))
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
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    v1_in = [(randn(qs, dt, gen), randn(ks, dt, gen), randn(ks, dt, gen))
             for _, qs, ks, dt, _ in V1_CASES]
    b12_in = [b12_inputs(gen, fmt, lens) for _, fmt, lens in B12_CASES]

    # ---- the main path: counts zeroed just before, read just after ----
    tfa.flash_attention_v1.launches = 0
    tfa.flash_attention_v1.f32_launches = 0
    paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    v1_out = [tfa.flash_attention_v1(q, k, v, causal=case[4],
                                     return_lse=True)
              for case, (q, k, v) in zip(V1_CASES, v1_in)]
    b12_out = [paged_decode_attention(*x) for x in b12_in]
    torch.cuda.synchronize()
    launches = {"flash_v1": tfa.flash_attention_v1.launches,
                "flash_v1_f32": tfa.flash_attention_v1.f32_launches,
                "paged_decode_separate": paged_decode_attention.launches}
    # ---------------------------------------------------------------------
    want = {"flash_v1": len(V1_CASES),
            "flash_v1_f32": sum(c[3] == torch.float32 for c in V1_CASES),
            "paged_decode_separate": len(B12_CASES)}
    log(f"B14/B12 surface: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"surface launches {launches} != {want}")

    rows = {}
    for (name, qs, ks, dt, causal), (q, k, v), (out, lse) in zip(
            V1_CASES, v1_in, v1_out):
        sc = qs[-1] ** -0.5
        # the dtype gate and, for bf16, B1's gate at the q fold (row by
        # row, the LSE at 1e-4), against FA1's plain version
        errs, folded, ok = flash_gate(
            out, lse, lambda qq, s2: flash_attention_v1_plain(
                qq, k, v, causal=causal, sm_scale=s2), q, dt)
        ok = ok and bool(torch.isfinite(out).all())
        if causal and qs[2] == ks[2]:
            v1_planted_faults(name, q, k, v, sc)
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
            f"{causal} | {flash_readings(errs, folded)} ({gate_text(dt)}) | "
            f"FA1 kernel {t_kernel:.4f} ms ({bound_ms / t_kernel:.1%} of the "
            f"bound, {t_kernel / t_sdpa:.2f}x SDPA), B1 (FA2) "
            f"{t_fa2:.4f} ms ({bound_ms / t_fa2:.1%} of the bound, "
            f"{t_fa2 / t_sdpa:.2f}x SDPA): FA1/FA2 "
            f"{t_kernel / t_fa2:.2f}x | plain "
            f"{t_plain:.4f} ms sdpa {t_sdpa:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"FA1 kernel disagrees with plain: {name}")
        rows[name] = {"max_abs_err": max(errs["out"], errs["lse"]),
                      "ms": t_kernel, "plain_ms": t_plain,
                      "library_ms": t_sdpa, "bound_ms": bound_ms,
                      "bound_by": bound_by, "fa2_ms": t_fa2}
    del v1_in, v1_out

    for (name, fmt, _), (q, k, v, lengths, table), (out, lse) in zip(
            B12_CASES, b12_in, b12_out):
        sc = q.shape[-1] ** -0.5
        n_splits, per = kernel_splits(table.shape[1], 128)
        plain = (lambda sp: paged_decode_plain(
            q, k, v, lengths, table, sm_scale=sc, splits=sp))
        err, row, lse_err, ok = split_errs(out, lse, plain)
        check_v_faults(f"separate {name}", b12_faults(q, k, v, lengths,
                                                      table), plain)
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
            f"{tuple(kv.shape)} lengths {lengths.tolist()} | {n_splits} "
            f"splits of {per} pages | {gate_readings(err, row, lse_err)} | "
            f"kernel {t_kernel:.4f} ms plain "
            f"{t_plain:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) | "
            f"{kv_bytes / (t_kernel * 1e-3) / 1e9:.1f} GB/s{extra} | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"B12 kernel disagrees with plain: {name}")
        rows[name] = {"max_abs_err": max(err, lse_err), "ms": t_kernel,
                      "plain_ms": t_plain, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return {"launches": launches, "rows": rows}


# --- the quantized forward: flash_attention_quantized ------------------------

# The JAX package's two quantized-prefill benchmarks (benchmarks/
# attention_bench.py:108-143), bf16 q, causal: (name, payload format, q
# shape, kv shape). The fp8 chunk sits at the decode offset 28672.
QUANT_BENCH = [
    ("int8 prefill s2048", "int8", (2, 8, 2048, 128), (2, 2, 2048, 128)),
    ("fp8 chunked prefill, 4096 rows of 32768", "fp8", (1, 8, 4096, 128),
     (1, 2, 32768, 128)),
]
# The masks, causal: (name, format, q shape, kv shape, q dtype, window,
# the packed jagged mix's ids)
QUANT_MASK_CASES = [
    ("window 256", "fp8", (1, 8, 1024, 128), (1, 2, 1024, 128),
     torch.bfloat16, 256, False),
    ("packed jagged mix", "int8", (1, 8, 9984, 128), (1, 2, 9984, 128),
     torch.bfloat16, None, True),
    ("q_len 1024 > kv_len 512, empty rows", "fp8", (1, 8, 1024, 128),
     (1, 2, 512, 128), torch.bfloat16, None, False),
    ("f32 q over int8", "int8", (1, 8, 1024, 128), (1, 2, 1024, 128),
     torch.float32, None, False),
]
# The quantized kernel against its plain version on the LSE (out: the
# dtype gates, of min(1, max|ref|): at the fp8 chunk's ~30k visible columns
# |out| is ~1e-2, under the bare gate): both take s from the same products,
# summed in another order.
QUANT_LSE_GATE = 1e-4


def quant_bound(q, kq, pairs: float) -> tuple[float, str]:
    """Least time for the quantized forward on `pairs` visible pairs: 4 * d
    flops a pair at q's dtype's peak (the products run on the converted
    payload); q read and out written once in q's dtype, the K and V
    payloads (1 byte an element) and their f32 scales read once, the f32
    LSE written once."""
    nbytes = (2 * q.numel() * q.element_size() + 2 * kq.values.numel()
              + 2 * kq.scales.numel() * 4 + q[..., 0].numel() * 4)
    return _bound(4.0 * q.shape[-1] * pairs, nbytes, q.dtype)


def visible(q_len, kv_len, *, window=None, seg=None) -> torch.Tensor:
    """The causal mask with the decode offset (and the window, the ids) as
    a boolean (b or 1, 1, q_len, kv_len) tensor for SDPA."""
    pos = torch.arange(q_len, device="cuda")[:, None] + kv_len - q_len
    cols = torch.arange(kv_len, device="cuda")[None, :]
    mask = cols <= pos
    if window is not None:
        mask &= cols > pos - window
    mask = mask[None, None]
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return mask


def tolerance_for_text(dtype) -> str:
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    return f"{tolerance_for(dtype):.0e} of min(1, max|ref|)"


def quant_lse_gate(dtype) -> float:
    """The quantized forward's LSE gate: QUANT_LSE_GATE, and the f32 gate
    with f32 q (both sides compute in f32)."""
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    return min(QUANT_LSE_GATE, tolerance_for(dtype))


def quant_gate(out, lse, ref, ref_lse) -> tuple[float, float, float, bool]:
    """(out err, max|ref|, lse err, ok): a quantized call's (out, lse)
    against its plain version's, out within the dtype gate times min(1,
    max|ref|), the LSE within `quant_lse_gate`, out finite."""
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    ref_max = float(ref.float().abs().max())
    ok = (err <= tolerance_for(out.dtype) * min(1.0, ref_max)
          and lse_err <= quant_lse_gate(out.dtype)
          and bool(torch.isfinite(out).all()))
    return err, ref_max, lse_err, ok


def quant_planted_faults(name, q, kq, vq, ref, ref_lse) -> None:
    """Three faults of the quantized pipeline (causal), planted in the rows
    of the last q tile (128 rows, the ones that read the most kv tiles) of
    the plain version and put through the quantized gate (`quant_gate`)
    against the sound plain version, as B1's planted faults are: (1) the
    bf16 stage of kv tile j left over from tile j - 1 (its conversion
    skipped: tile j's payloads are tile j - 1's, its scales its own); (2)
    the k scales shifted by one token; (3) the v scales ignored (all 1); j
    the middle kv tile (of the instance's tiles) of those rows. Each must
    fail the gate."""
    from tiny_flash_attention_tpu_torch.ops.flash import fwd_config
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized_plain)

    q_len, kv_len = q.shape[2], kq.shape[2]
    bn = fwd_config(q.dtype, True, q.shape[-1]).block_n
    j = kv_len // bn // 2
    tile, prev = slice(j * bn, (j + 1) * bn), slice((j - 1) * bn, j * bn)
    rows = slice(q_len - 128, q_len)
    ks, vs = kq.scales, vq.scales
    stale = []
    for x in (kq.values, vq.values):
        y = x.clone()
        y[:, :, tile] = x[:, :, prev]
        stale.append(y)
    faults = {
        f"stage of kv tile {j} left from tile {j - 1}": (*stale, ks, vs),
        "k scales shifted by one token": (
            kq.values, vq.values, torch.roll(ks, 1, dims=2), vs),
        "v scales ignored": (kq.values, vq.values, ks, torch.ones_like(vs)),
    }
    for label, (kk, vv, fks, fvs) in faults.items():
        f_out, f_lse = flash_attention_quantized_plain(
            q[:, :, rows], kk, vv, fks, fvs, causal=True,
            sm_scale=q.shape[-1] ** -0.5, return_lse=True)
        out, lse = ref.clone(), ref_lse.clone()
        out[:, :, rows], lse[:, :, rows] = f_out, f_lse
        err, ref_max, lse_err, ok = quant_gate(out, lse, ref, ref_lse)
        log(f"{name}: planted fault in the last q tile's rows, {label}: out "
            f"err {err / ref_max:.3e} of max|ref| (gate "
            f"{tolerance_for_text(q.dtype)}) lse err {lse_err:.3e} (gate "
            f"{quant_lse_gate(q.dtype):.0e}) | "
            f"{'PASSES THE GATE' if ok else 'caught'}")
        if ok:
            raise AssertionError(f"the quantized gate passes a planted "
                                 f"fault: {name}, {label}")
        del f_out, f_lse, out, lse


def check_quant(name, q, kq, vq, out, lse, *, faults=False, **kw) -> float:
    """One quantized call against its plain version on the card
    (`quant_gate`). Prints, for information, the largest difference from
    SDPA over the dequantized K/V on the rows that see a column. With
    `faults` (causal, no other mask), the planted faults of
    `quant_planted_faults` must fail the same gate."""
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized_plain)

    q_len, kv_len = q.shape[2], kq.shape[2]
    ref, ref_lse = flash_attention_quantized_plain(
        q, kq.values, vq.values, kq.scales, vq.scales, causal=True,
        sm_scale=q.shape[-1] ** -0.5, return_lse=True, **kw)
    err, ref_max, lse_err, ok = quant_gate(out, lse, ref, ref_lse)
    if faults:
        quant_planted_faults(name, q, kq, vq, ref, ref_lse)
    del ref, ref_lse
    seg = None if kw.get("segment_ids") is None else kw["segment_ids"][0]
    mask = visible(q_len, kv_len, window=kw.get("window"), seg=seg)
    sdpa = F.scaled_dot_product_attention(
        q, kq.dequantize(q.dtype), vq.dequantize(q.dtype), attn_mask=mask,
        enable_gqa=True)
    seen = mask.any(dim=-1).expand(out.shape[:3])
    sdpa_err = max_err(out[seen], sdpa[seen])
    del sdpa, mask
    log(f"{name}: q{tuple(q.shape)} {str(kq.dtype).split('.')[-1]} "
        f"kv{tuple(kq.shape)} | out err {err:.3e} = {err / ref_max:.3e} of "
        f"max|ref| {ref_max:.3e} (gate {tolerance_for_text(q.dtype)}) lse "
        f"err {lse_err:.3e} (gate {quant_lse_gate(q.dtype):.0e}) against "
        f"the plain "
        f"version | SDPA over the dequantized K/V differs by "
        f"{sdpa_err:.3e} (information) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"quantized kernel disagrees with plain: {name}")
    return max(err, lse_err)


def quant_flash_phase(gen) -> dict:
    """The quantized forward on its path, the package entry
    `flash_attention_quantized` (JAX's is on no model path either), at the
    JAX package's two benchmark shapes: the counts zeroed just before and
    read just after; then each output against its plain version, the
    device times of the call, of B1 on the bf16 K/V it was quantized from
    (JAX's yardstick in the benchmark) and of SDPA on those, beside the
    bound; then the masks at smaller shapes."""
    import tiny_flash_attention_tpu_torch as tfa
    from tiny_flash_attention_tpu_torch.models.engine import pack_prompts
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    fq = tfa.flash_attention_quantized
    bench_in = []
    for _, fmt, qs, ks in QUANT_BENCH:
        q = randn(qs, torch.bfloat16, gen)
        k, v = (randn(ks, torch.bfloat16, gen) for _ in range(2))
        bench_in.append((q, k, v, *Q.quantize_kv(k, v, fmt)))

    # ---- the main path: counts zeroed just before, read just after ----
    fq.launches = fq.int8_launches = fq.fp8_launches = 0
    torch.cuda.synchronize()
    outs = [fq(q, kq, vq, causal=True, return_lse=True)
            for q, _, _, kq, vq in bench_in]
    torch.cuda.synchronize()
    launches = {"int8": fq.int8_launches, "fp8": fq.fp8_launches}
    # ---------------------------------------------------------------------
    log(f"quantized flash: launches {launches}, {fq.launches} in all "
        f"(expected one of each)")
    if launches != {"int8": 1, "fp8": 1} or fq.launches != 2:
        raise AssertionError(f"quantized launches {launches}")

    rows, worst = {}, {"int8": 0.0, "fp8": 0.0}
    for (name, fmt, _, _), (q, k, v, kq, vq) in zip(QUANT_BENCH, bench_in):
        out, lse = outs.pop(0)
        worst[fmt] = check_quant(f"quantized flash {name}", q, kq, vq, out,
                                 lse, faults=True)
        del out, lse
        sc = q.shape[-1] ** -0.5
        mask = None if q.shape[2] == k.shape[2] else visible(q.shape[2],
                                                              k.shape[2])
        t_kernel = cuda_time_ms(lambda: fq(q, kq, vq, causal=True),
                                iters=10)["median_ms"]
        t_b1 = cuda_time_ms(lambda: flash_attention(q, k, v, causal=True),
                            iters=10)["median_ms"]
        t_sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True), iters=10)["median_ms"]
        t_plain = cuda_time_ms(lambda: flash_attention_quantized_plain(
            q, kq.values, vq.values, kq.scales, vq.scales, causal=True,
            sm_scale=sc), iters=2)["median_ms"]
        bound_ms, bound_by = quant_bound(q, kq, mask_pairs(q, k, True))
        b1_bound = flash_bound(q, k, True)[0]
        log(f"quantized flash {name}: kernel {t_kernel:.4f} ms, B1 on the "
            f"bf16 K/V {t_b1:.4f} ms ({b1_bound / t_b1:.1%} of its bound, "
            f"{t_b1 / t_sdpa:.2f}x SDPA; quantized/B1 "
            f"{t_kernel / t_b1:.3f}x), "
            f"SDPA on the bf16 K/V {t_sdpa:.4f} ms, plain {t_plain:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, "
            f"{bound_ms / t_kernel:.1%} of it)")
        rows[fmt] = {"ms": t_kernel, "plain_ms": t_plain,
                     "library_ms": t_sdpa, "bound_ms": bound_ms,
                     "bound_by": bound_by, "b1_ms": t_b1}
        del mask
    del bench_in

    for name, fmt, qs, ks, dtype, window, packed in QUANT_MASK_CASES:
        q = randn(qs, dtype, gen)
        kq, vq = Q.quantize_kv(randn(ks, dtype, gen), randn(ks, dtype, gen),
                               fmt)
        kw = {"window": window}
        starts = None
        if packed:
            _, segs, _, starts = pack_prompts([[0] * n for n in JAGGED_MIX],
                                              128, "page")
            seg = torch.as_tensor(segs, device="cuda")
            kw["segment_ids"] = (seg, seg)
        out, lse = fq(q, kq, vq, causal=True, return_lse=True, **kw)
        torch.cuda.synchronize()
        err = check_quant(f"quantized flash {name}", q, kq, vq, out, lse,
                          **kw)
        if qs[2] > ks[2] and not bool(
                (out[:, :, :qs[2] - ks[2]] == 0).all()):
            raise AssertionError(f"{name}: rows before every kv position "
                                 "are not 0")
        if packed:
            pruned = fq(q, kq, vq, causal=True, return_lse=True,
                        segment_starts=starts, **kw)
            same = all(torch.equal(x, y) for x, y in zip(pruned, (out, lse)))
            log(f"quantized flash {name}: segment_starts bit-equal to none: "
                f"{same}")
            if not same:
                raise AssertionError("segment_starts changed the quantized "
                                     "packed output")
        worst[fmt] = max(worst[fmt], err)
        del q, kq, vq, out, lse
    for fmt in rows:
        rows[fmt]["max_abs_err"] = worst[fmt]
    rows.update(quant_f32q_rows(gen, fq))
    launches.update({f"{fmt}_f32q": rows[f"{fmt}_f32q"].pop("launches")
                     for fmt in ("int8", "fp8")})
    return {"launches": launches, "rows": rows}


def quant_f32q_rows(gen, fq) -> dict:
    """The f32 body's quantized instances: f32 q over int8 and e4m3
    payloads at the int8 benchmark's shape, the counts zeroed just before
    and read just after; each against its plain version with the planted
    faults (`check_quant`), then the device times of the call, of the
    plain version and of SDPA in f32 on the dequantized K/V, beside the
    bound. Returns {"int8_f32q": row, "fp8_f32q": row}, each row with its
    launches."""
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    _, _, qs, ks = QUANT_BENCH[0]
    q = randn(qs, torch.float32, gen)
    k, v = (randn(ks, torch.float32, gen) for _ in range(2))
    kv = {fmt: Q.quantize_kv(k, v, fmt) for fmt in ("int8", "fp8")}
    del k, v
    # ---- the main path: counts zeroed just before, read just after ----
    fq.launches = fq.int8_launches = fq.fp8_launches = 0
    torch.cuda.synchronize()
    outs = {fmt: fq(q, kq, vq, causal=True, return_lse=True)
            for fmt, (kq, vq) in kv.items()}
    torch.cuda.synchronize()
    launches = {"int8": fq.int8_launches, "fp8": fq.fp8_launches}
    # ---------------------------------------------------------------------
    if launches != {"int8": 1, "fp8": 1} or fq.launches != 2:
        raise AssertionError(f"f32-q quantized launches {launches}")
    rows = {}
    for fmt, (kq, vq) in kv.items():
        name = f"quantized flash f32 q over {fmt} at {qs}/{ks[:2]}"
        out, lse = outs.pop(fmt)
        err = check_quant(name, q, kq, vq, out, lse, faults=True)
        del out, lse
        t_kernel = cuda_time_ms(lambda: fq(q, kq, vq, causal=True),
                                iters=10)["median_ms"]
        kd, vd = kq.dequantize(torch.float32), vq.dequantize(torch.float32)
        t_sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, is_causal=True, enable_gqa=True), iters=10)[
            "median_ms"]
        del kd, vd
        t_plain = cuda_time_ms(lambda: flash_attention_quantized_plain(
            q, kq.values, vq.values, kq.scales, vq.scales, causal=True,
            sm_scale=qs[-1] ** -0.5), iters=2)["median_ms"]
        bound_ms, bound_by = quant_bound(q, kq, mask_pairs(q, kq, True))
        log(f"{name}: kernel {t_kernel:.4f} ms, SDPA f32 on the dequantized "
            f"K/V {t_sdpa:.4f} ms ({t_kernel / t_sdpa:.2f}x), plain "
            f"{t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{bound_ms / t_kernel:.1%} of it); launches {launches[fmt]}")
        rows[f"{fmt}_f32q"] = {"max_abs_err": err, "ms": t_kernel,
                               "plain_ms": t_plain, "library_ms": t_sdpa,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "launches": launches[fmt]}
    return rows


# --- head_dim 256 in the quantized forward and FA1 ---------------------------

# The quantized forward at Gemma-2B's attention widths (8 q heads over one
# kv head of 256: DIMS_MODELS) on the JAX package's two benchmark patterns
# (QUANT_BENCH), bf16 q, causal: (name, payload format, q shape, kv shape).
# The fp8 chunk sits at the decode offset 28672.
WIDE_QUANT_BENCH = [
    ("int8 prefill s2048 at 256", "int8", (2, 8, 2048, 256),
     (2, 1, 2048, 256)),
    ("fp8 chunked prefill at 256, 4096 rows of 32768", "fp8",
     (1, 8, 4096, 256), (1, 1, 32768, 256)),
]
# ... the masks at smaller shapes, at 192 (padded to 256) and at 256,
# causal: (name, format, q shape, kv shape, q dtype, window, segment
# bounds)
WIDE_QUANT_MASK_CASES = [
    ("d 192, window 256", "fp8", (1, 8, 1024, 192), (1, 1, 1024, 192),
     torch.bfloat16, 256, None),
    ("d 192, segment ids, f32 q", "int8", (1, 8, 1024, 192),
     (1, 1, 1024, 192), torch.float32, None, (300, 700)),
    ("d 256, window 200, f32 q", "fp8", (1, 8, 1024, 256), (1, 1, 1024, 256),
     torch.float32, 200, None),
    ("d 256, segment ids", "int8", (1, 8, 1024, 256), (1, 1, 1024, 256),
     torch.bfloat16, None, (300, 700)),
]
# FA1 at row 14's shapes (PERF.md) at 256, MHA, and at 192 (padded):
# (name, q shape (k and v alike), dtype, causal)
WIDE_V1_CASES = [
    ("MHA causal 2048 at 256", (2, 8, 2048, 256), torch.bfloat16, True),
    ("MHA non-causal 2048 at 256", (2, 8, 2048, 256), torch.bfloat16,
     False),
    ("MHA causal 1024 f32 at 256", (2, 8, 1024, 256), torch.float32, True),
]
WIDE_V1_PAD_CASES = [
    ("d 192 causal", (2, 8, 1024, 192), torch.bfloat16, True),
    ("d 192 non-causal f32", (1, 8, 1024, 192), torch.float32, False),
]


def wide_quant_v1_phase(gen) -> dict:
    """head_dim 256 in the quantized forward and FA1, through the package
    entries (neither is on a model path, in JAX or here) at Gemma-2B's
    attention widths: `flash_attention_quantized` with bf16 q at both
    WIDE_QUANT_BENCH patterns and with f32 q over int8 and over e4m3 at the
    first, `flash_attention_v1` at WIDE_V1_CASES, each group with the
    counts zeroed just before and read just after, and no pad copy. Then
    each output against its plain version (the quantized gate; FA1 at its
    dtype gate and, in bf16, the fold's row gate) with the planted faults
    of the 128 rows, and the device times of the call, of its plain
    version, of SDPA on the K/V that were quantized (FA1: on the same
    q/k/v) and of B1 on them, beside the bound at the true head_dim; then
    the masks and 192 at smaller shapes, 3 pad copies a call at 192."""
    import tiny_flash_attention_tpu_torch as tfa
    from tiny_flash_attention_tpu_torch.ops import dims
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized_plain)
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        flash_attention_v1_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    fq, v1 = tfa.flash_attention_quantized, tfa.flash_attention_v1
    # (row key, name, q, the bf16 or f32 K/V, their QuantizedTensors)
    calls = []
    for name, fmt, qs, ks in WIDE_QUANT_BENCH:
        q = randn(qs, torch.bfloat16, gen)
        k, v = (randn(ks, torch.bfloat16, gen) for _ in range(2))
        calls.append((fmt, name, q, k, v, *Q.quantize_kv(k, v, fmt)))
    _, _, qs, ks = WIDE_QUANT_BENCH[0]
    q = randn(qs, torch.float32, gen)
    k, v = (randn(ks, torch.float32, gen) for _ in range(2))
    for fmt in ("int8", "fp8"):
        calls.append((f"{fmt}_f32q", f"f32 q over {fmt} at {qs}/{ks[:2]}",
                      q, k, v, *Q.quantize_kv(k, v, fmt)))
    del q, k, v
    v1_in = [tuple(randn(qs, dt, gen) for _ in range(3))
             for _, qs, dt, _ in WIDE_V1_CASES]
    copies = dims.pad_head_dim.copies
    launches, outs = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        group = [c for c in calls if c[2].dtype == dtype]
        # ---- the main path: counts zeroed just before, read just after --
        fq.launches = fq.int8_launches = fq.fp8_launches = 0
        torch.cuda.synchronize()
        outs += [fq(c[2], c[5], c[6], causal=True, return_lse=True)
                 for c in group]
        torch.cuda.synchronize()
        got = {"int8": fq.int8_launches, "fp8": fq.fp8_launches}
        # -----------------------------------------------------------------
        if got != {"int8": 1, "fp8": 1} or fq.launches != 2:
            raise AssertionError(f"wide quantized launches {got} "
                                 f"({dtype})")
        for c in group:
            launches[c[0]] = got[c[0].split("_")[0]]
    # ---- the main path: counts zeroed just before, read just after ----
    v1.launches = v1.f32_launches = 0
    torch.cuda.synchronize()
    v1_out = [v1(q, k, v, causal=case[3], return_lse=True)
              for case, (q, k, v) in zip(WIDE_V1_CASES, v1_in)]
    torch.cuda.synchronize()
    launches["v1"], launches["v1_f32"] = v1.launches, v1.f32_launches
    # ---------------------------------------------------------------------
    copies = dims.pad_head_dim.copies - copies
    want_v1 = (len(WIDE_V1_CASES),
               sum(c[2] == torch.float32 for c in WIDE_V1_CASES))
    log(f"wide quantized and FA1: launches {launches} (one each; FA1 "
        f"{want_v1[0]}, {want_v1[1]} of them f32), pad copies at 256: "
        f"{copies}")
    if (launches["v1"], launches["v1_f32"]) != want_v1 or copies:
        raise AssertionError(f"wide FA1 launches {launches}, {copies} pad "
                             "copies at 256")

    rows = {}
    for (key, name, q, k, v, kq, vq), (out, lse) in zip(calls, outs):
        err = check_quant(f"wide quantized flash {name}", q, kq, vq, out,
                          lse, faults=True)
        del out, lse
        sc = q.shape[-1] ** -0.5
        mask = None if q.shape[2] == k.shape[2] else visible(q.shape[2],
                                                              k.shape[2])
        t_kernel = cuda_time_ms(lambda: fq(q, kq, vq, causal=True),
                                iters=10)["median_ms"]
        t_b1 = cuda_time_ms(lambda: flash_attention(q, k, v, causal=True),
                            iters=10)["median_ms"]
        t_sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True), iters=10)["median_ms"]
        t_plain = cuda_time_ms(lambda: flash_attention_quantized_plain(
            q, kq.values, vq.values, kq.scales, vq.scales, causal=True,
            sm_scale=sc), iters=2)["median_ms"]
        bound_ms, bound_by = quant_bound(q, kq, mask_pairs(q, k, True))
        b1_bound = flash_bound(q, k, True)[0]
        kv = str(k.dtype).split(".")[-1]
        log(f"wide quantized flash {name}: kernel {t_kernel:.4f} ms, B1 on "
            f"the {kv} K/V {t_b1:.4f} ms ({b1_bound / t_b1:.1%} of its "
            f"bound, {t_b1 / t_sdpa:.2f}x SDPA; quantized/B1 "
            f"{t_kernel / t_b1:.3f}x), SDPA on the {kv} K/V {t_sdpa:.4f} "
            f"ms ({t_kernel / t_sdpa:.2f}x), plain {t_plain:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / t_kernel:.1%} of "
            f"it); launches {launches[key]}")
        rows[key] = {"max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                     "library_ms": t_sdpa, "bound_ms": bound_ms,
                     "bound_by": bound_by, "b1_ms": t_b1}
        del mask
    del calls, outs

    for name, fmt, qs, ks, dtype, window, bounds in WIDE_QUANT_MASK_CASES:
        q = randn(qs, dtype, gen)
        kq, vq = Q.quantize_kv(randn(ks, dtype, gen), randn(ks, dtype, gen),
                               fmt)
        kw = {"window": window}
        if bounds is not None:
            seg = segment_ids(qs[0], qs[2], bounds)
            kw["segment_ids"] = (seg, seg)
        before = dims.pad_head_dim.copies
        out, lse = fq(q, kq, vq, causal=True, return_lse=True, **kw)
        torch.cuda.synchronize()
        copies = dims.pad_head_dim.copies - before
        err = check_quant(f"wide quantized flash {name}", q, kq, vq, out,
                          lse, **kw)
        want = 3 * (qs[-1] != 256)
        log(f"wide quantized flash {name}: {copies} pad copies (expected "
            f"{want})")
        if copies != want:
            raise AssertionError(f"{name}: {copies} pad copies")
        if bounds is not None:
            pruned = fq(q, kq, vq, causal=True, return_lse=True,
                        segment_starts=(0, *bounds), **kw)
            if not all(torch.equal(x, y) for x, y in zip(pruned,
                                                         (out, lse))):
                raise AssertionError(f"{name}: segment_starts changed the "
                                     "output")
        key = fmt if dtype == torch.bfloat16 else f"{fmt}_f32q"
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
        del q, kq, vq, out, lse

    def v1_check(name, q, k, v, causal, out, lse):
        errs, folded, ok = flash_gate(
            out, lse, lambda qq, s2: flash_attention_v1_plain(
                qq, k, v, causal=causal, sm_scale=s2), q, q.dtype)
        ok = ok and bool(torch.isfinite(out).all())
        log(f"wide flash_v1 {name}: q{tuple(q.shape)} "
            f"{str(q.dtype).split('.')[-1]} causal={causal} | "
            f"{flash_readings(errs, folded)} ({gate_text(q.dtype)}) | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"FA1 kernel disagrees with plain: {name}")
        return max(errs["out"], errs["lse"])

    for (name, qs, dt, causal), (q, k, v), (out, lse) in zip(
            WIDE_V1_CASES, v1_in, v1_out):
        err = v1_check(name, q, k, v, causal, out, lse)
        del out, lse
        sc = qs[-1] ** -0.5
        if causal:
            v1_planted_faults(name, q, k, v, sc)
        t_kernel = cuda_time_ms(lambda: v1(q, k, v, causal=causal),
                                iters=10)["median_ms"]
        t_b1 = cuda_time_ms(lambda: flash_attention(q, k, v, causal=causal),
                            iters=10)["median_ms"]
        t_plain = cuda_time_ms(lambda: flash_attention_v1_plain(
            q, k, v, causal=causal, sm_scale=sc), iters=5)["median_ms"]
        t_sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters=10)["median_ms"]
        bound_ms, bound_by = flash_bound(q, k, causal)
        log(f"wide flash_v1 {name}: FA1 kernel {t_kernel:.4f} ms "
            f"({bound_ms / t_kernel:.1%} of the bound, "
            f"{t_kernel / t_sdpa:.2f}x SDPA), B1 (FA2) {t_b1:.4f} ms "
            f"({bound_ms / t_b1:.1%} of the bound, {t_b1 / t_sdpa:.2f}x "
            f"SDPA): FA1/FA2 {t_kernel / t_b1:.2f}x | plain {t_plain:.4f} "
            f"ms sdpa {t_sdpa:.4f} ms bound {bound_ms:.4f} ms ({bound_by})")
        key = "v1" if dt == torch.bfloat16 else "v1_f32"
        if key in rows:   # the first case of each dtype is the row
            rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
        else:
            rows[key] = {"max_abs_err": err, "ms": t_kernel,
                         "plain_ms": t_plain, "library_ms": t_sdpa,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "b1_ms": t_b1}
    del v1_in, v1_out
    for name, qs, dt, causal in WIDE_V1_PAD_CASES:
        q, k, v = (randn(qs, dt, gen) for _ in range(3))
        before = dims.pad_head_dim.copies
        out, lse = v1(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        copies = dims.pad_head_dim.copies - before
        err = v1_check(name, q, k, v, causal, out, lse)
        log(f"wide flash_v1 {name}: {copies} pad copies (expected 3)")
        if copies != 3:
            raise AssertionError(f"{name}: {copies} pad copies")
        key = "v1" if dt == torch.bfloat16 else "v1_f32"
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
        del q, k, v, out, lse
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
        plain=lambda x=q, s=d ** -0.5: flash_attention_plain(
            x, k, v, causal=True, sm_scale=s, window=window,
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
            f"bit-equal to B1's; bound {bound[0]:.4f} ms ({bound[1]}), "
            f"{bound[0] / t_row:.1%} of it, {t_row / row['library_ms']:.2f}x "
            f"SDPA")
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
               ps=128, P=16, dtype=torch.bfloat16) -> dict:
    """B4's ring mode against its plain version over a table that has
    wrapped (the windowed engine's geometry: 16 pages of 128 a slot), q and
    the K/V the pages are made from in `dtype`."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_attention, fused_paged_decode_plain,
        pack_paged_cache)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    num_pages = batch * P + 8
    q = randn((batch, hq, d), dtype, gen)
    pages = pack_paged_cache(
        randn((hkv, num_pages, ps, d), dtype, gen),
        randn((hkv, num_pages, ps, d), dtype, gen), fmt)
    perm = torch.randperm(num_pages, generator=gen, device="cuda")
    table = perm[:batch * P].reshape(batch, P).to(torch.int32)
    lengths = torch.tensor([1, window, window + 65, P * ps, P * ps + 1,
                            P * ps + 700, 3 * P * ps + 5, 9000],
                           dtype=torch.int32, device="cuda")
    n_splits, per = kernel_splits(P, ps, window)
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    err, row, lse_err, ok = split_errs(
        out, lse, lambda sp: fused_paged_decode_plain(
            q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
            window=window, splits=sp))
    t_kernel = cuda_time_ms(lambda: fused_paged_decode_attention(
        q, pages, lengths, table, page_size=ps, window=window),
        iters=20)["median_ms"]
    t_plain = cuda_time_ms(lambda: fused_paged_decode_plain(
        q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
        window=window), iters=5)["median_ms"]
    bound_ms, bound_by = ring_bound(q, pages, lengths, window)
    log(f"ring decode {name}: q{tuple(q.shape)} "
        f"{str(dtype).split('.')[-1]} pages{tuple(pages.shape)} "
        f"{str(pages.dtype).split('.')[-1]} "
        f"table{tuple(table.shape)} window {window} lengths "
        f"{lengths.tolist()} | {n_splits} splits of {per} pages | "
        f"{gate_readings(err, row, lse_err)} | kernel {t_kernel:.4f} ms plain "
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
                   lambda: eng.steps(PROFILE_STEPS), PROFILE_STEPS,
                   STEP_LAUNCHES["windowed"])

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


def profile_window(label: str, fn, n: int, launches=None,
                   watch=None) -> None:
    """Where the time of fn() goes, per unit of n: the device time of its
    kernels from torch.profiler, against fn's wall time taken without the
    profiler (which slows the host). With `launches`, fails unless the
    launches per unit are that many: the kernels by their device records,
    the copies and sets by the runtime API calls the host made (a small
    pageable host-to-device copy may have no device record, in every
    profile of a process: PERF.md, section 7); on a miss it prints first
    the records whose count is not a whole number a unit and those calls.
    With `watch`, also prints the device time a launch of the kernels whose
    name holds it (L2 as the run leaves it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # started at once, fn loses the first device records of about one
        # profile in twenty (a prefix of its kernels, in any tree); a pause
        # lets the profiler settle (PERF.md, section 7)
        time.sleep(PROFILE_SETTLE_S)
        fn()
        torch.cuda.synchronize()
    # user annotations (the optimizer's step) span kernels counted anyway
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"profile {label}: the profiler recorded no device time "
            "(not measured)")
        if launches is not None:
            raise AssertionError(f"profile {label}: no launches recorded")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
    # what the host issued: the runtime API's launch, copy and set calls
    calls = {e.key: e.count for e in events
             if e.device_type == DeviceType.CPU and e.key.startswith("cu")
             and any(w in e.key for w in ("Launch", "Memcpy", "Memset"))}
    got = (sum(e.count for e in kernels
               if not e.key.startswith(("Memcpy", "Memset")))
           + sum(c for key, c in calls.items()
                 if "Memcpy" in key or "Memset" in key)) / n
    log(f"profile {label}: wall {wall_ms:.3f} ms unprofiled, device "
        f"kernels {busy_ms:.3f} ms, device busy {busy_ms / wall_ms:.1%}, "
        f"{got:.0f} kernel launches")
    for e in kernels[:8]:
        log(f"  {e.self_device_time_total / n / 1e3:.4f} ms "
            f"{e.count / n:5.1f}x  {e.key[:90]}")
    if watch is not None:
        seen = [e for e in kernels if watch in e.key]
        count = sum(e.count for e in seen)
        each = (sum(e.self_device_time_total for e in seen) / count / 1e3
                if count else float("nan"))
        log(f"  {watch}: {count / n:.1f} launches a unit, {each:.5f} ms a "
            f"launch in this profile")
    if launches is not None and got != launches:
        log(f"profile {label}: records not a whole number of times a unit: "
            + "; ".join(f"{e.count} x {e.key[:70]}" for e in kernels
                        if e.count % n)
            + f"; the runtime API's launch and copy calls "
            f"{sum(calls.values()) / n} a unit: {calls}")
        raise AssertionError(f"profile {label}: {got} launches a step, the "
                             f"parent tree's {launches}")


def main_path_rows(seed: int) -> int:
    """Only the rows this tree must keep, device ms each, with the package
    found on sys.path (so that one call can time two trees' kernels): B1
    bf16 at (4,8,768,128), (4,8,2048,128) and (1,8,8192,128) causal, B11 at
    the jagged batch of the mix, B1 f32 and the f32 backward call at the
    f32 train step's shape, f32 q over int8 and e4m3 payloads at the int8
    benchmark's shape, bf16 q over int8 and e4m3 at both quantized
    benchmarks (QUANT_BENCH), FA1 at (2,8,2048,128) bf16 and (2,8,1024,128)
    f32 causal, the bf16
    backward call at (4,8,2048,128), (1,8,8192,128) and (2,8,768,128), B4
    over int8 pages of 8016 tokens and over a bf16 engine cache, the append
    cold beside the launch floor; B1 at (4,32,2048,96) and the backward at
    (1,32,2048,96), the Phi-3-mini-width calls (a tree that pads them
    times its pads too); then the bf16 engine's decode step (its launches
    and the append's time a launch in it) and the f32 train step (B1 f32's
    time a launch in it), each profiled twice."""
    import tiny_flash_attention_tpu_torch as tfa
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.models.engine import (
        InferenceEngine, Request)
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd)
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {gpu_info()}; package {tfa.__file__}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    times = {}
    for n in (768, 2048):
        q = randn((4, 8, n, 128), torch.bfloat16, gen)
        k, v = (randn((4, 2, n, 128), torch.bfloat16, gen) for _ in range(2))
        times[f"B1 (4,8,{n})"] = cuda_time_ms(
            lambda: flash_attention(q, k, v, causal=True),
            iters=20)["median_ms"]
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    do = randn(q.shape, torch.bfloat16, gen)
    times["bwd call (4,8,2048)"] = cuda_time_ms(
        lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=True),
        iters=10)["median_ms"]
    # the long row (B1 row 3, the backward's row 7), the short backward
    # (row 8) and the Phi-3-mini-width calls
    for label, qs, ks, fwd, bwd in (
            ("(1,8,8192)", (1, 8, 8192, 128), (1, 2, 8192, 128), True, True),
            ("(2,8,768)", (2, 8, 768, 128), (2, 2, 768, 128), False, True),
            ("(4,32,2048,96)", (4, 32, 2048, 96), (4, 32, 2048, 96), True,
             False),
            ("(1,32,2048,96)", (1, 32, 2048, 96), (1, 32, 2048, 96), False,
             True)):
        q = randn(qs, torch.bfloat16, gen)
        k, v = (randn(ks, torch.bfloat16, gen) for _ in range(2))
        if fwd:
            times[f"B1 {label}"] = cuda_time_ms(
                lambda: flash_attention(q, k, v, causal=True),
                iters=10)["median_ms"]
        if bwd:
            out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
            do = randn(q.shape, torch.bfloat16, gen)
            times[f"bwd call {label}"] = cuda_time_ms(
                lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                            causal=True),
                iters=10)["median_ms"]
    q = randn((8, 8, 4096, 128), torch.bfloat16, gen)
    k, v = (randn((8, 2, 4096, 128), torch.bfloat16, gen) for _ in range(2))
    lt = torch.tensor(JAGGED_MIX, dtype=torch.int32, device="cuda")
    times["B11 jagged mix"] = cuda_time_ms(
        lambda: flash_attention_rowloop(q, k, v, causal=True, seq_lengths=lt),
        iters=10)["median_ms"]
    q_shape, kv_shape = F32_FWD_SHAPE
    q = randn(q_shape, torch.float32, gen)
    k, v = (randn(kv_shape, torch.float32, gen) for _ in range(2))
    times["B1 f32 (1,8,1024)"] = cuda_time_ms(
        lambda: flash_attention(q, k, v, causal=True), iters=20)["median_ms"]
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    do = randn(q.shape, torch.float32, gen)
    times["bwd call f32 (1,8,1024)"] = cuda_time_ms(
        lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=True),
        iters=10)["median_ms"]
    _, _, qs, ks = QUANT_BENCH[0]
    q = randn(qs, torch.float32, gen)
    k, v = (randn(ks, torch.float32, gen) for _ in range(2))
    for fmt in ("int8", "fp8"):
        kq, vq = Q.quantize_kv(k, v, fmt)
        times[f"f32 q {fmt}"] = cuda_time_ms(
            lambda: tfa.flash_attention_quantized(q, kq, vq, causal=True),
            iters=20)["median_ms"]
    for name, fmt, qs, ks in QUANT_BENCH:
        q = randn(qs, torch.bfloat16, gen)
        kq, vq = Q.quantize_kv(randn(ks, torch.bfloat16, gen),
                               randn(ks, torch.bfloat16, gen), fmt)
        times[f"quantized {name}"] = cuda_time_ms(
            lambda: tfa.flash_attention_quantized(q, kq, vq, causal=True),
            iters=10)["median_ms"]
    for name, qs, ks, dt, causal in (V1_CASES[0], V1_CASES[2]):
        q, k, v = (randn(qs, dt, gen) for _ in range(3))
        times[f"FA1 {name}"] = cuda_time_ms(
            lambda: tfa.flash_attention_v1(q, k, v, causal=causal),
            iters=10)["median_ms"]
    del q, k, v, kq, vq, out, lse, do
    x = decode_inputs_int8(gen, ps=128, P=64)
    lengths = torch.full((8,), 8016, dtype=torch.int32, device="cuda")
    times["B4 int8 8016"] = cuda_time_ms(
        lambda: fused_paged_decode_attention(x[0], x[1], lengths, x[3],
                                             page_size=128),
        iters=20)["median_ms"]
    del x
    for fmt in ("int8", "bf16"):
        pages, k_new, v_new, ids, rows = append_inputs(gen, fmt=fmt, ps=128)
        times[f"append {fmt}"] = cuda_time_ms(
            lambda: fused_page_append(pages, k_new, v_new, ids, rows,
                                      page_size=128), iters=50)["median_ms"]
    times["launch floor"] = launch_floor_ms(50)
    cfg = engine_config()
    params = T.init_params(cfg, gen, device="cuda")
    eng = InferenceEngine(cfg, params, num_pages=8 * 32 + 8, page_size=128,
                          max_seqs=8, pages_per_seq=32, seed=seed,
                          device="cuda")
    rng = np.random.default_rng(seed)
    eng.add_requests([Request(rng.integers(0, cfg.vocab_size, n).tolist(),
                              64) for n in rng.integers(600, 2049, 8)])
    eng.steps(8)
    table, lengths = eng.cache.device_views()
    qd = randn((8, cfg.n_q_heads, cfg.d_head), torch.bfloat16, gen)
    times["B4 bf16 engine cache"] = cuda_time_ms(
        lambda: fused_paged_decode_attention(qd, eng.cache.pages[0], lengths,
                                             table, page_size=128),
        iters=20)["median_ms"]
    log("rows (device ms): " + "; ".join(f"{key} {t:.4f}"
                                         for key, t in times.items()))
    for _ in range(2):
        profile_window(f"per decode step (steps({PROFILE_STEPS}), 8 slots)",
                       lambda: eng.steps(PROFILE_STEPS), PROFILE_STEPS,
                       STEP_LAUNCHES["bf16"], watch="page_append")
    del eng, params
    train_f32_profile(seed)
    return 0


# --- phase 8: head dims and GQA groups no instance compiles ------------------

# B1 (bf16 and f32) at head dims it pads (72: no multiple of 16) and groups
# 1, 3, 7, each under one mask: (d, group, mask)
DIMS_FLASH_CASES = [(72, 1, "causal"), (72, 3, "window"), (72, 7, "ids"),
                    (80, 1, "window"), (80, 3, "ids"), (80, 7, "causal"),
                    (96, 1, "ids"), (96, 3, "causal"), (96, 7, "window")]
# B4 at head_dim 80 and 96 and the groups it pads, (d, group, page size)
DIMS_DECODE_CASES = [(80, 3, 64), (80, 5, 128), (80, 7, 64), (80, 12, 128),
                     (80, 16, 64), (96, 3, 128), (96, 5, 64), (96, 7, 128),
                     (96, 12, 64), (96, 16, 128)]
# the model whose head dims run on the instances of width 512 (wider_phase)
V4_MODEL = "DeepSeek-V4-Flash widths"
# The models served at published widths (their config.json), 4 layers:
# (label, ModelConfig fields, bf16 page size, int8 page size: JAX's int8
# page rule needs page_size <= head_dim or a multiple of it)
DIMS_MODELS = [
    ("Phi-3-mini widths", dict(vocab_size=32064, d_model=3072, n_q_heads=32,
                               n_kv_heads=32, d_head=96, d_ff=8192,
                               rope_theta=10000.0, rms_eps=1e-5), 128, 64),
    ("Llama-3.2-3B widths", dict(vocab_size=128256, d_model=3072,
                                 n_q_heads=24, n_kv_heads=8, d_head=128,
                                 d_ff=8192, rope_theta=500000.0,
                                 rms_eps=1e-5), 128, 128),
    # google/gemma-2b's widths (its config.json): head_dim 256, one kv head
    # (group 8, MQA), n_q_heads * d_head == d_model; the llama-family
    # decoder runs them (Gemma's GeGLU, (1 + w) norm and embedding scale
    # are not in the JAX package)
    ("Gemma-2B widths", dict(vocab_size=256000, d_model=2048, n_q_heads=8,
                             n_kv_heads=1, d_head=256, d_ff=16384,
                             rope_theta=10000.0, rms_eps=1e-6), 128, 128),
    # openlm-research/open_llama_3b_v2's widths (its config.json): a plain
    # llama model, 32/32 heads of 100; served over bf16 pages of 48 tokens
    # and int8 pages of 100 (<= head_dim: JAX's rule), both on the decodes'
    # run-time width instances (no instance of head_dim 100 compiles; the
    # flash prefill pads 100 to 128)
    ("OpenLLaMA-3B widths", dict(vocab_size=32000, d_model=3200,
                                 n_q_heads=32, n_kv_heads=32, d_head=100,
                                 d_ff=8640, rope_theta=10000.0,
                                 rms_eps=1e-6), 48, 100),
    # deepseek-ai/DeepSeek-V4-Flash's attention widths, typed in from its
    # config.json (https://huggingface.co/deepseek-ai/DeepSeek-V4-Flash/
    # blob/main/config.json): hidden_size 4096, 64 attention heads over 1
    # kv head of head_dim 512, vocab 129280, rms eps 1e-6; the MLP takes one
    # shared expert's width (moe_intermediate_size 2048) as d_ff. The
    # llama-family decoder runs these widths only: the routed experts, the
    # low-rank q and o projections, the compressed and learned-sparse
    # attention, the hyper-connections and MTP are not in the JAX package.
    # Served over bf16 pages of 64 tokens and int8 pages of 128 (<= 512,
    # JAX's int8 rule); 2,250.3 M parameters at 4 layers (the untied embed
    # and lm_head 1,059.1 M, each layer 297.8 M). Its phase is
    # wider_phase, which also takes its train step pair (the backward's
    # instance of width 512).
    (V4_MODEL, dict(vocab_size=129280, d_model=4096, n_q_heads=64,
                    n_kv_heads=1, d_head=512, d_ff=2048, rope_theta=10000.0,
                    rms_eps=1e-6), 64, 128),
]
# the model whose head_dim and page sizes run on the run-time widths
WIDTH_MODEL = "OpenLLaMA-3B widths"
DIMS_LAYERS = 4
# the models whose train step pair runs: Phi-3-mini's (beside the same
# pair padded), Gemma-2B's and DeepSeek-V4-Flash's (head_dim 256 and 512,
# tile widths: nothing pads)
DIMS_TRAIN = ("Phi-3-mini widths", "Gemma-2B widths", V4_MODEL)


def dims_mask(mask, b, n) -> dict:
    """The keywords of one mask: causal, a window of 200, or causal with
    segment ids changing off the tiles (with "starts", their static
    segment_starts too, which prune each q tile's kv range)."""
    if mask == "window":
        return {"causal": True, "window": 200}
    if mask in ("ids", "starts"):
        seg = segment_ids(b, n, (300, 777))
        kw = {"causal": True, "segment_ids": (seg, seg)}
        if mask == "starts":
            kw["segment_starts"] = (0, 300, 777)
        return kw
    return {"causal": True}


def check_dims_flash(d, group, mask, dtype, gen) -> float:
    """B1 at a head_dim no instance has (bf16: read in place; f32: padded)
    against its plain version at the true one (the dtype gate, and in
    bf16 the gate at the q fold with the LSE); returns the worst error. At
    head_dim 96 (192) also planted faults: the plain version at the padded
    head_dim's scale (1/sqrt(128), 1/sqrt(256): what a default scale taken
    after the padding would give) must fail the gate, and in bf16 so must
    out as an epilogue that stored all 128 (256) columns of the tile at
    stride 96 (192) (all_columns_epilogue); at 392 the same against the
    instance of width 512."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    b, hkv, n = 2, 2, 1024
    q = randn((b, hkv * group, n, d), dtype, gen)
    k, v = randn((b, hkv, n, d), dtype, gen), randn((b, hkv, n, d), dtype,
                                                    gen)
    kw = dims_mask(mask, b, n)
    starts = kw.pop("segment_starts", None)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True,
                               segment_starts=starts, **kw)
    torch.cuda.synchronize()

    def plain(qq, sc):
        return flash_attention_plain(qq, k, v, sm_scale=sc, return_lse=True,
                                     **kw)

    errs, folded, ok = flash_gate(out, lse, plain, q, dtype)
    ok = (ok and out.shape == q.shape and bool(torch.isfinite(out).all())
          and flash_attention.launches == before + 1)
    log(f"dims: flash d {d} group {group} {mask} "
        f"{str(dtype).split('.')[-1]} q{tuple(q.shape)} | "
        f"{flash_readings(errs, folded)} ({gate_text(dtype)}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees at head_dim {d}")
    tile = {96: 128, 192: 256, 392: 512}.get(d)   # the padded width of d
    if tile:
        f_out, f_lse = plain(q, tile ** -0.5)
        f_errs, f_folded, f_ok = flash_gate(f_out, f_lse, plain, q, dtype)
        log(f"dims: flash d {d} {str(dtype).split('.')[-1]}: planted fault, "
            f"sm_scale 1/sqrt({tile}): {flash_readings(f_errs, f_folded)} | "
            f"{'PASSES THE GATE' if f_ok else 'caught'}")
        if f_ok:
            raise AssertionError("the flash gate passes a wrong sm_scale")
    if tile and dtype == torch.bfloat16:
        e_errs, e_folded, e_ok = flash_gate(all_columns_epilogue(out, tile),
                                            lse, plain, q, dtype)
        log(f"dims: flash d {d} group {group} bfloat16: planted fault, an "
            f"epilogue storing all {tile} columns at stride {d}: "
            f"{flash_readings(e_errs, e_folded)} | "
            f"{'PASSES THE GATE' if e_ok else 'caught'}")
        if e_ok:
            raise AssertionError(f"the flash gate passes an epilogue that "
                                 f"stores all {tile} columns")
    return max(errs["out"], errs["lse"])


def check_dims_b12(gen, d=96, hq=6, hkv=2, dtype=torch.bfloat16) -> dict:
    """B12 at a head_dim and group of its own (hq / hkv), q in `dtype`
    over pages of that dtype and int8 pages, against its plain version at
    the kernel's splits and unsplit, with its planted faults; the device
    times of the kernel and the plain version beside the bound. Returns a
    row per format, with the launches of the checked calls."""
    from tiny_flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    rows, label = {}, f"d {d} group {hq // hkv}"
    for fmt in ("bf16", "int8"):
        q, k, v, lengths, table = b12_inputs(
            gen, fmt, [1, 127, 128, 129, 1000, 4096, 6000, 8192], hq=hq,
            hkv=hkv, d=d, P=64, dtype=dtype)
        before = paged_decode_attention.launches
        out, lse = paged_decode_attention(q, k, v, lengths, table)
        launches = paged_decode_attention.launches - before
        torch.cuda.synchronize()
        plain = (lambda sp: paged_decode_plain(
            q, k, v, lengths, table, sm_scale=d ** -0.5, splits=sp))
        err, row, lse_err, ok = split_errs(out, lse, plain)
        check_v_faults(f"separate {label} {fmt}",
                       b12_faults(q, k, v, lengths, table), plain)
        t_kernel = cuda_time_ms(lambda: paged_decode_attention(
            q, k, v, lengths, table), iters=10)["median_ms"]
        t_plain = cuda_time_ms(lambda: paged_decode_plain(
            q, k, v, lengths, table, sm_scale=d ** -0.5),
            iters=5)["median_ms"]
        kv = k.values if fmt == "int8" else k
        bound_ms, bound_by = decode_bound(q, kv, lengths, table, 128)
        pages = "int8" if fmt == "int8" else str(dtype).split('.')[-1]
        log(f"dims: paged_decode_separate {label} {pages} pages "
            f"q{tuple(q.shape)} {str(dtype).split('.')[-1]} | "
            f"{gate_readings(err, row, lse_err)} | "
            f"kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"B12 disagrees at head_dim {d}")
        rows[fmt] = {"max_abs_err": max(err, lse_err), "ms": t_kernel,
                     "plain_ms": t_plain, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "launches": launches}
    return rows


@contextlib.contextmanager
def padded_head_dims():
    """The calls inside pad every head_dim to the kernels' tile width
    through pad_head_dim and slice back, as before the bf16 kernels read it
    in place (ops/dims.py::reads_in_place taking the tile widths only)."""
    from tiny_flash_attention_tpu_torch.ops import dims
    keep = dims.reads_in_place
    dims.reads_in_place = lambda d: d in (*dims.FLASH_HEAD_DIMS,
                                          dims.WIDE_HEAD_DIM,
                                          dims.WIDER_HEAD_DIM)
    try:
        yield
    finally:
        dims.reads_in_place = keep


# a device kernel that copies or pads (the pads, slices and contiguous
# copies around a padded call)
COPY_KERNEL = re.compile("copy|pad", re.IGNORECASE)


def kernel_names(fn):
    """The device kernels one call of fn() launches, in order, from
    torch.profiler; None where the profiler recorded no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SETTLE_S)   # as in profile_window
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return names or None


def kernel_short_name(name: str) -> str:
    """A device kernel's name without its namespace, template arguments
    and parameters (its first identifier followed by '<' or '(')."""
    m = re.search(r"(\w+)(?=[<(])", name)
    return m.group(1) if m else name[:40]


def copy_readings(names, padded_names) -> tuple[str, bool]:
    """The profile's verdict on one in-place call: its kernels (short
    names), whether any copies or pads, and the padded call's copies for
    contrast; (text, ok). No profile reads "not measured" and passes on
    the counter alone."""
    if names is None or padded_names is None:
        return "kernels not measured (no device records)", True
    short = sorted({kernel_short_name(n) for n in names})
    copies = [n for n in names if COPY_KERNEL.search(n)]
    padded = sum(bool(COPY_KERNEL.search(n)) for n in padded_names)
    return (f"kernels {short}, {len(copies)} copy or pad kernels (the "
            f"padded call: {padded} of {len(padded_names)})", not copies)


def time_turns(calls: dict, rounds: int = 2) -> dict:
    """Device times (cuda_time_ms medians, L2 cold) of each call in turns,
    `rounds` times: {label: [ms, ...]}."""
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    times = {label: [] for label in calls}
    for _ in range(rounds):
        for label, fn in calls.items():
            times[label].append(cuda_time_ms(fn, iters=10)["median_ms"])
    return times


def spread(ts) -> str:
    return f"{min(ts):.4f}–{max(ts):.4f}" if len(ts) > 1 else f"{ts[0]:.4f}"


def in_place_fwd(d: int, gen, shape=(4, 32, 2048), hkv=None) -> dict:
    """B1 at (b, h, n, d) causal (h / hkv q heads a kv head) on tensors of
    head_dim d: the call makes no pad copy (pad_head_dim's counter; no
    copy or pad kernel in its profile), and its out and LSE, on the
    instance it takes and, up to 128, on the 128-wide one, are the bits of
    the padded call (padded_head_dims: three pads, the 128- or 256-wide
    instance, the slice of out). Then the device times of the in-place
    call on each instance, the padded call and SDPA at head_dim d, in
    turns in this call, beside the bound at head_dim d."""
    from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
    from tiny_flash_attention_tpu_torch.ops.dims import pad_head_dim
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention

    b, h, n = shape
    hkv = hkv or h
    q = randn((b, h, n, d), torch.bfloat16, gen)
    k, v = (randn((b, hkv, n, d), torch.bfloat16, gen) for _ in range(2))
    wide = d > 128
    inst = ("n512" if d > 256 else "n256") if wide else f"n{d}"

    def fwd(narrow=True, padded=False, lse=True):
        # narrow: the width-80/96 instances (products over the true head
        # dims), else the 128-wide one (over the tiles' zero columns too)
        with (padded_head_dims() if padded else contextlib.nullcontext()):
            return flash_attention(
                q, k, v, causal=True, return_lse=lse,
                config=FlashConfig(narrow_products=narrow))

    copies = pad_head_dim.copies
    calls = {inst: fwd()}
    if not wide:
        calls["n128"] = fwd(narrow=False)
    in_copies = pad_head_dim.copies - copies
    ref = fwd(padded=True)
    pad_copies = pad_head_dim.copies - copies - in_copies
    torch.cuda.synchronize()
    bits = {name: all(torch.equal(a, b) for a, b in zip(x, ref))
            for name, x in calls.items()}
    del calls, ref
    prof, ok_prof = copy_readings(kernel_names(lambda: fwd(lse=False)),
                                  kernel_names(lambda: fwd(padded=True,
                                                           lse=False)))
    timed = {inst: lambda: fwd(lse=False)}
    if not wide:
        timed["n128"] = lambda: fwd(narrow=False, lse=False)
    times = time_turns({
        **timed, "padded call": lambda: fwd(padded=True, lse=False),
        "sdpa": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=hkv != h)})
    bound_ms, bound_by = flash_bound(q, k, True)
    kept = inst if wide or FlashConfig().narrow_products else "n128"
    faster = min(timed, key=lambda x: min(times[x]))
    ok = in_copies == 0 and all(bits.values()) and ok_prof
    log(f"dims: B1 at ({b},{h},{n},{d})/({b},{hkv}) causal read in place: "
        f"pad copies {in_copies} (the padded call {pad_copies}); {prof}; "
        f"out and LSE bit-identical to the padded call: {bits} | "
        + ", ".join(f"{x} {spread(t)} ms" for x, t in times.items())
        + f", bound {bound_ms:.4f} ms ({bound_by}) | {kept} (kept) "
        f"{bound_ms / min(times[kept]):.1%} of the bound, "
        f"{min(times[kept]) / min(times['sdpa']):.2f}x SDPA, "
        f"{min(times['padded call']) / min(times[kept]):.2f}x faster than "
        f"the padded call; faster instance: {faster} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"B1 at head_dim {d} copies or differs from "
                             f"the padded call")
    return {"times": times, "kept": kept, "bound_ms": bound_ms}


def in_place_bwd(d: int, gen, shape=(1, 32, 2048), hkv=None) -> dict:
    """The bf16 backward at (b, h, n, d) causal on tensors of head_dim d,
    as in_place_fwd: no pad copy, no copy or pad kernel; dq, dk and dv on
    each instance the bits of the padded call (five pads, three slices);
    then the device times of the call on each instance, its main kernel on
    each, the padded call and SDPA's backward at head_dim d, in turns,
    beside the bound."""
    from tiny_flash_attention_tpu_torch.ops.configs import FlashConfig
    from tiny_flash_attention_tpu_torch.ops.dims import pad_head_dim
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        BwdLaunch, flash_attention_bwd)

    b, h, n = shape
    hkv = hkv or h
    q, do = (randn((b, h, n, d), torch.bfloat16, gen) for _ in range(2))
    k, v = (randn((b, hkv, n, d), torch.bfloat16, gen) for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    wide = d > 128
    inst = "n512" if d > 256 else "n256" if wide else f"n{d}"

    def bwd(narrow=True, padded=False):
        with (padded_head_dims() if padded else contextlib.nullcontext()):
            return flash_attention_bwd(
                q, k, v, out, lse, do, causal=True,
                config=FlashConfig(narrow_products=narrow))

    def main_kernel(narrow):
        call = BwdLaunch(q, k, v, out, lse, do, causal=True,
                         sm_scale=d ** -0.5,
                         config=FlashConfig(narrow_products=narrow))
        call.run(1)
        return lambda: call.run(2)

    copies = pad_head_dim.copies
    calls = {inst: bwd()}
    if not wide:
        calls["n128"] = bwd(narrow=False)
    in_copies = pad_head_dim.copies - copies
    ref = bwd(padded=True)
    pad_copies = pad_head_dim.copies - copies - in_copies
    torch.cuda.synchronize()
    bits = {name: all(torch.equal(a, b) for a, b in zip(x, ref))
            for name, x in calls.items()}
    del calls, ref
    prof, ok_prof = copy_readings(kernel_names(bwd),
                                  kernel_names(lambda: bwd(padded=True)))
    sq, sk, sv = (t.detach().requires_grad_() for t in (q, k, v))
    s_out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True,
                                           enable_gqa=hkv != h)
    timed = {inst: bwd, f"main {inst}": main_kernel(True)}
    if not wide:
        timed.update({"n128": lambda: bwd(narrow=False),
                      "main n128": main_kernel(False)})
    times = time_turns({
        **timed, "padded call": lambda: bwd(padded=True),
        "sdpa bwd": lambda: torch.autograd.grad(s_out, (sq, sk, sv), do,
                                                retain_graph=True)})
    del s_out
    bound_ms, bound_by = bwd_bound(q, k, "all", mask_pairs(q, k, True))
    kept = inst if wide or FlashConfig().narrow_products else "n128"
    faster = min((x for x in timed if not x.startswith("main")),
                 key=lambda x: min(times[x]))
    ok = in_copies == 0 and all(bits.values()) and ok_prof
    log(f"dims: backward at ({b},{h},{n},{d})/({b},{hkv}) causal read in "
        f"place: pad copies {in_copies} (the padded call {pad_copies}); "
        f"{prof}; dq, dk, dv bit-identical to the padded call: {bits} | "
        + ", ".join(f"{x} {spread(t)} ms" for x, t in times.items())
        + f", bound {bound_ms:.4f} ms ({bound_by}) | {kept} (kept) "
        f"{bound_ms / min(times[kept]):.1%} of the bound, "
        f"{min(times[kept]) / min(times['sdpa bwd']):.2f}x SDPA, "
        f"{min(times['padded call']) / min(times[kept]):.2f}x faster than "
        f"the padded call; faster instance: {faster} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the backward at head_dim {d} copies or "
                             f"differs from the padded call")
    return {"times": times, "kept": kept, "bound_ms": bound_ms}


def all_columns_epilogue(out: torch.Tensor, width: int) -> torch.Tensor:
    """out (..., d) as an epilogue that stored all `width` columns of each
    row (the tile's, zeros past d) at stride d would leave it, the rows
    stored from the last down (the grid walks its q tiles from the last):
    each row's columns past d land on the first width - d columns of the
    rows after it, as zeros."""
    d = out.shape[-1]
    rows = F.pad(out, (0, width - d)).reshape(-1, width)
    got = rows[:, :d].clone()
    k = 1
    while k * d < width:      # row r - k reaches row r's first columns
        got[k:, :width - k * d] = rows[:-k, k * d:]
        k += 1
    return got.reshape(out.shape)


def dims_phase(gen) -> dict:
    """Every kernel at the head dims and groups that no instance compiles,
    against its plain version: B1 (bf16, f32; causal, window, ids; the
    fold, the LSE, a wrong-scale fault), its quantized instances, the
    backward, FA1, B4 (bf16, f32, int8 pages, the ring mode, planted V
    faults), B12 and B5 (bit for bit); and the time of B1 at head_dim 96
    and 80 and of the backward at 96, read in place, beside their bound at
    the true head_dim, SDPA and the padded call, on both instances."""
    from tiny_flash_attention_tpu_torch.ops import quant as Q
    from tiny_flash_attention_tpu_torch.ops.flash_quant import (
        flash_attention_quantized)
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        flash_attention_v1, flash_attention_v1_plain)
    from tiny_flash_attention_tpu_torch.utils.testing import flash_gate

    rows = {"errs": {}}
    errs = rows["errs"]
    errs["flash_fwd"] = max(check_dims_flash(*c, torch.bfloat16, gen)
                            for c in DIMS_FLASH_CASES)
    errs["flash_fwd_f32"] = max(check_dims_flash(*c, torch.float32, gen)
                                for c in DIMS_FLASH_CASES)
    # the quantized forward at head_dim 96, group 3: payloads padded with
    # code 0, scales as they are
    q = randn((2, 24, 2048, 96), torch.bfloat16, gen)
    k, v = (randn((2, 8, 2048, 96), torch.bfloat16, gen) for _ in range(2))
    for fmt in ("int8", "fp8"):
        kq, vq = Q.quantize_kv(k, v, fmt)
        out, lse = flash_attention_quantized(q, kq, vq, causal=True,
                                             return_lse=True)
        errs[f"flash_fwd_quant_{fmt}"] = check_quant(
            f"dims: quantized flash {fmt} d 96 group 3", q, kq, vq, out, lse,
            faults=True)
    del q, k, v, kq, vq, out, lse
    # FA1 at head_dim 80
    for dtype, n in ((torch.bfloat16, 2048), (torch.float32, 1024)):
        q, k, v = (randn((2, 8, n, 80), dtype, gen) for _ in range(3))
        out, lse = flash_attention_v1(q, k, v, causal=True, return_lse=True)
        e, folded, ok = flash_gate(out, lse, lambda qq, sc:
                                   flash_attention_v1_plain(
                                       qq, k, v, causal=True, sm_scale=sc),
                                   q, dtype)
        log(f"dims: flash_v1 d 80 {str(dtype).split('.')[-1]} "
            f"q{tuple(q.shape)} | {flash_readings(e, folded)} "
            f"({gate_text(dtype)}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("FA1 disagrees at head_dim 80")
        key = "flash_v1" if dtype == torch.bfloat16 else "flash_v1_f32"
        errs[key] = max(e["out"], e["lse"])
    # B4: bf16 pages at every case, int8 pages at every case (at page size
    # 64 where the case's is neither at most head_dim nor a multiple of it:
    # JAX's int8 page rule), f32 at two; the ring mode; planted V faults at
    # one case of each format
    dec, dec8 = 0.0, 0.0
    for i, (d, group, ps) in enumerate(DIMS_DECODE_CASES):
        P = 4096 // ps
        x = decode_inputs(gen, hq=2 * group, d=d, ps=ps, P=P)
        r = check_decode(f"dims: bf16 d {d} group {group} ps {ps}", *x, ps,
                         iters=5, faults=i == 0)
        dec = max(dec, r["max_abs_err"])
        ps8 = ps if ps <= d or ps % d == 0 else 64
        x = decode_inputs_int8(gen, ps=ps8, P=4096 // ps8, hq=2 * group, d=d)
        r = check_decode(f"dims: int8 d {d} group {group} ps {ps8}", *x, ps8,
                         iters=5, faults=i == 5)
        dec8 = max(dec8, r["max_abs_err"])
    for d, group in ((80, 3), (96, 12)):
        x = decode_inputs(gen, hq=2 * group, d=d, ps=64, P=64,
                          dtype=torch.float32)
        check_decode(f"dims: f32 d {d} group {group} ps 64", *x, 64, iters=5)
    x = decode_inputs_int8(gen, ps=160, P=25, hq=6, d=80)
    r = check_decode("dims: int8 d 80 group 3 ps 160 (scale rows in two "
                     "groups)", *x, 160, iters=5)
    dec8 = max(dec8, r["max_abs_err"])
    for fmt, d, group in (("bf16", 96, 3), ("int8", 96, 7), ("bf16", 80, 16),
                          ("int8", 80, 5)):
        r = check_ring(f"dims: {fmt} d {d} group {group}", fmt, gen,
                       hq=2 * group, d=d, ps=64, P=32)
        if fmt == "bf16":
            dec = max(dec, r["max_abs_err"])
        else:
            dec8 = max(dec8, r["max_abs_err"])
    errs["paged_decode"], errs["paged_decode_int8"] = dec, dec8
    errs["paged_decode_separate"] = max(
        r["max_abs_err"] for r in check_dims_b12(gen).values())
    errs["page_append"] = max(
        check_append(f"dims: {fmt} d {d} ps {ps}", fmt, ps, gen, d=d,
                     iters=5)["max_abs_err"]
        for fmt, d, ps in (("bf16", 80, 128), ("bf16", 96, 128),
                           ("int8", 80, 64), ("int8", 80, 160),
                           ("int8", 96, 64), ("int8", 96, 96)))
    # the shapes of Phi-3-mini's widths timed: B1 at (4,32,2048,96) and at
    # head_dim 80, the backward at (1,32,2048,96), each read in place, beside
    # the bound at the true head_dim and SDPA; then the in-place call beside
    # the padded call and each instance in one call (in_place_fwd/_bwd)
    rows["flash"] = check_flash("dims: B1 at head_dim 96", (4, 32, 2048, 96),
                                (4, 32, 2048, 96), torch.bfloat16, True, gen,
                                faults=True)
    rows["flash80"] = check_flash("dims: B1 at head_dim 80",
                                  (4, 32, 2048, 80), (4, 32, 2048, 80),
                                  torch.bfloat16, True, gen)
    errs["flash_fwd"] = max(errs["flash_fwd"],
                            rows["flash"]["max_abs_err"],
                            rows["flash80"]["max_abs_err"])
    rows["in_place"] = {d: in_place_fwd(d, gen) for d in (96, 80)}
    rows["flash_bwd"] = check_bwd("dims: backward at head_dim 96",
                                  (1, 32, 2048, 96), (1, 32, 2048, 96),
                                  torch.bfloat16, True, {}, gen)
    errs["flash_bwd"] = rows["flash_bwd"]["max_abs_err"]
    rows["in_place_bwd"] = in_place_bwd(96, gen)
    return rows


# --- phase 8b: head_dim 256, the wide instances ----------------------------

# B1 at head dims in (128, 256] read in place (and 136, the least above
# 128) and groups 1, 2, 8 (Gemma's MQA, GQA and MHA members), each under
# one mask: (d, group, mask)
WIDE_FLASH_CASES = [(256, 1, "causal"), (256, 2, "window"), (256, 8, "ids"),
                    (192, 1, "ids"), (192, 2, "causal"), (192, 8, "window"),
                    (136, 8, "causal")]
# Gemma-2B's prefill and train step: (q shape, kv shape)
WIDE_FWD_SHAPE = ((4, 8, 2048, 256), (4, 1, 2048, 256))
WIDE_BWD_SHAPE = ((1, 8, 2048, 256), (1, 1, 2048, 256))


def wide_phase(gen) -> dict:
    """Every kernel of the bf16 serving and training path at head_dim 256
    (and 192, 136: in place on the wide instances) against its plain
    version: B1 under each mask and group with planted faults at 192 (a
    scale from 256, an epilogue storing all 256 columns), at Gemma-2B's
    prefill shape timed beside SDPA and the bound, and at 192 read in place
    beside the padded call; the backward at Gemma-2B's train step, with the
    window at 192 and the jagged mix's ids and starts at 256, in place at
    192, its spread at 256; B4's ring mode and B12 over bf16 and int8
    pages; B5 bit for bit. (B4 over a Gemma-2B-width engine cache is timed
    in dims_model_phase.)"""
    rows = {"errs": {}}
    errs = rows["errs"]
    errs["flash_fwd"] = max(check_dims_flash(*c, torch.bfloat16, gen)
                            for c in WIDE_FLASH_CASES)
    rows["flash"] = check_flash("wide: B1 at the Gemma-2B prefill",
                                *WIDE_FWD_SHAPE, torch.bfloat16, True, gen,
                                faults=True)
    errs["flash_fwd"] = max(errs["flash_fwd"], rows["flash"]["max_abs_err"])
    rows["in_place"] = in_place_fwd(192, gen, shape=(4, 8, 2048), hkv=1)
    rows["flash_bwd"] = check_bwd("wide: backward at the Gemma-2B train step",
                                  *WIDE_BWD_SHAPE, torch.bfloat16, True, {},
                                  gen)
    worst = rows["flash_bwd"]["max_abs_err"]
    for case in (("wide: backward at 192, window 200", (2, 4, 1000, 192),
                  (2, 2, 1000, 192), torch.bfloat16, True, {"window": 200}),
                 ("wide: backward at 256, the jagged mix's ids and starts",
                  (1, 8, 9984, 256), (1, 2, 9984, 256), torch.bfloat16, True,
                  {"mix": True, "starts": True})):
        worst = max(worst, check_bwd(*case, gen, iters=3)["max_abs_err"])
    errs["flash_bwd"] = worst
    rows["in_place_bwd"] = in_place_bwd(192, gen, shape=(1, 8, 2048), hkv=1)
    bwd_spread(gate=True, d=256)
    ring = 0.0
    for fmt, group in (("bf16", 1), ("bf16", 8), ("int8", 2), ("int8", 8)):
        r = check_ring(f"wide: {fmt} d 256 group {group}", fmt, gen,
                       hq=group, hkv=1, d=256, ps=128, P=16)
        ring = max(ring, r["max_abs_err"])
    errs["ring"] = ring
    rows["b12"] = check_dims_b12(gen, d=256, hq=8, hkv=1)
    errs["paged_decode_separate"] = max(r["max_abs_err"]
                                        for r in rows["b12"].values())
    rows["append"] = {
        (fmt, ps): check_append(f"wide: {fmt} d 256 ps {ps}, Gemma-2B's 8 "
                                f"tokens x 1 kv head", fmt, ps, gen, d=256,
                                hkv=1, iters=10)
        for fmt, ps in (("bf16", 128), ("int8", 128), ("int8", 256))}
    errs["page_append"] = max(r["max_abs_err"]
                              for r in rows["append"].values())
    return rows


def dims_engine_run(label, cfg, params, fmt, ps, seed,
                    gate=ENGINE_LOGIT_GATE) -> dict:
    """One engine at a model's published widths: 8 prompts of 512-2048
    tokens admitted in two batches of 4, two steps(32) chunks, the launch
    counts zeroed just before the admissions and read just after the
    chunks; then the longer admission's prefill logits and the first
    decode step, each against the same call with every kernel swapped for
    its plain version (plain_kernels), within `gate` (ENGINE_LOGIT_GATE in
    bf16) of the largest |logit|, and the engine's greedy tokens the
    argmax of the kernels' logits."""
    from tiny_flash_attention_tpu_torch.models.engine import (
        InferenceEngine, Request, pad_prompts)
    from tiny_flash_attention_tpu_torch.models.inference import (
        decode_step, prefill_forward_batched)
    from tiny_flash_attention_tpu_torch.ops.dims import (
        DECODE_HEAD_DIMS, decode_compiled)
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)

    max_seqs, n_chunk, n_chunks = 8, 32, 2
    pps = -(-(2048 + n_chunk * n_chunks + 8) // ps)
    eng = InferenceEngine(cfg, params, num_pages=max_seqs * pps + 8,
                          page_size=ps, max_seqs=max_seqs, pages_per_seq=pps,
                          kv_format=fmt, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    lens = sorted(int(n) for n in rng.integers(512, 2049, max_seqs))
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).tolist(),
                    1 + n_chunk * n_chunks + 8) for n in lens]
    attr = "int8_launches" if fmt == "int8" else "launches"
    dec = f"paged_decode{'_int8' if fmt == 'int8' else ''}"

    # ---- the main path: counts zeroed just before, read just after ----
    flash_attention.launches = 0
    setattr(fused_paged_decode_attention, attr, 0)
    fused_paged_decode_attention.width_launches = 0
    fused_page_append.launches = 0
    fused_page_append.width_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in (reqs[:4], reqs[4:]):
        eng.add_requests(batch)
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
    launches = {"flash_fwd": flash_attention.launches,
                dec: getattr(fused_paged_decode_attention, attr),
                "page_append": fused_page_append.launches,
                f"{dec}_widths": fused_paged_decode_attention.width_launches,
                "page_append_widths": fused_page_append.width_launches}
    # ---------------------------------------------------------------------

    # the compiled widths' models launch no run-time width instance; a
    # model at another head_dim or page size launches only those
    steps, L = n_chunk * n_chunks, cfg.n_layers
    d = cfg.d_head
    want = dict(zip(launches, (
        2 * L, steps * L, steps * L,
        0 if decode_compiled(d, ps) else steps * L,
        0 if d in DECODE_HEAD_DIMS else steps * L)))
    log(f"dims engine [{label}, {fmt} pages "
        f"({str(eng.cache.pages[0].dtype).split('.')[-1]}) ps {ps}]: "
        f"prompts {lens}; "
        f"launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"dims engine launches {launches} != {want}")
    for r in reqs:
        assert len(r.generated) == 1 + steps, len(r.generated)

    long = reqs[4:]
    toks = torch.as_tensor(pad_prompts([r.prompt for r in long], ps),
                           device="cuda")
    rows = torch.arange(len(long), device="cuda")
    last = torch.tensor([len(r.prompt) - 1 for r in long], device="cuda")

    def first_step():
        dec, _ = decode_step(
            cfg, params, [p.clone() for p in snap["pages"]],
            torch.as_tensor(snap["last"], device="cuda"),
            torch.as_tensor(snap["lengths"], device="cuda"),
            torch.as_tensor(snap["table"], device="cuda"), page_size=ps,
            fmt=fmt)
        return dec

    slots = torch.tensor([r.slot for r in reqs], device="cuda")
    got_pre = prefill_forward_batched(cfg, params, toks)[0][rows, last]
    got_dec = first_step()[slots]
    with plain_kernels():
        ref_pre = prefill_forward_batched(cfg, params, toks)[0][rows, last]
        ref_dec = first_step()[slots]
    worst = 0.0
    for what, got, ref, tokens in (
            ("prefill (the longer admission)", got_pre, ref_pre,
             [r.generated[0] for r in long]),
            ("first decode step", got_dec, ref_dec,
             [r.generated[1] for r in reqs])):
        scale = float(ref.abs().max())
        err = max_err(got, ref)
        limit = gate * scale
        argmax = got.argmax(-1).tolist()
        same = sum(a == b for a, b in zip(argmax, ref.argmax(-1).tolist()))
        log(f"dims engine [{label}, {fmt}]: {what} vs plain kernels: max err "
            f"{err:.3e} (gate {limit:.3e} = {gate:.2%} of max |logit| "
            f"{scale:.3f}); tokens {tokens} vs argmax {argmax} (the plain "
            f"kernels' argmax agrees on {same} of {len(argmax)})")
        if err > limit or not torch.isfinite(got).all():
            raise AssertionError(f"dims engine logits disagree: {label}")
        if tokens != argmax:
            raise AssertionError(f"dims engine tokens are not the argmax: "
                                 f"{label}")
        worst = max(worst, err)
    tok_s = max_seqs * n_chunk / chunk_s[-1]
    log(f"dims engine [{label}, {fmt}] timing: two admissions of 4 "
        f"{prefill_ms:.1f} ms; decode steps({n_chunk}) "
        f"{[round(x * 1e3, 2) for x in chunk_s]} ms -> {tok_s:.0f} tokens/s "
        f"(8 slots, last chunk)")
    return {"launches": launches, "engine": eng, "err": worst}


def wide_decode_groups(label, fmt, pages, lengths, table, ps, gen,
                       dtype=torch.bfloat16, groups=(1, 2, 8)) -> dict:
    """B4 at the head_dim of a wide engine cache (layer 0, one kv head:
    256 at Gemma-2B's widths, 512 at DeepSeek-V4-Flash's) at `groups`
    (above the instances' top as row blocks of it), q in `dtype`, against
    its plain version (planted V faults at the last group), timed beside
    the bound, with every decode instance of that width of q's dtype's
    source and its registers and spill bytes. Returns {"rows": {group:
    row}}."""
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.ops.paged_fused import decode_entry

    d = pages.shape[-1]
    rows = {}
    for group in groups:
        q = randn((table.shape[0], group, d), dtype, gen)
        rows[group] = check_decode(
            f"wide: {label} {fmt} engine cache, layer 0, group {group}", q,
            pages, lengths, table, ps, iters=10, faults=group == groups[-1])
    regs = [x for x in spilling_instances(
        _build.build_log(decode_entry(dtype, d, ps)[0]), every=True)
        if f", {d}," in x]
    log(f"wide: {label} {fmt} decode, head_dim-{d} instances, "
        f"registers/spill bytes: {'; '.join(regs)}")
    return {"rows": rows}


def dims_model_phase(seed, models=None, train=True) -> dict:
    """The models at their published widths (DIMS_MODELS, or `models` of
    them), cut to DIMS_LAYERS layers, random weights from the seed: each
    served over bf16 pages and int8 pages at its page sizes
    (dims_engine_run); B4 timed over each bf16 engine's cache (layer 0)
    beside its bound, over the int8 engine's too where the run-time widths
    serve it, at head_dim 256 also at groups 1, 2, 8 over both caches
    (wide_decode_groups); then (with `train`) one train step pair at the
    widths of each of DIMS_TRAIN (1 x 2048, bf16, AdamW): the loss falls,
    the gradients agree with those through the plain attention; its peak
    device memory, beside that of the same pair from the same weights run
    padded (padded_head_dims) where the head_dim is not a tile width.
    Returns the launches in all and by model."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops.dims import decode_compiled

    totals, caches, int8_caches, by_model, wide = {}, {}, {}, {}, {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for label, fields, ps16, ps8 in models or DIMS_MODELS:
        mine = by_model.setdefault(label, {})
        cfg = T.ModelConfig(**fields, n_layers=DIMS_LAYERS,
                            dtype=torch.bfloat16)
        params = T.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(seed), device="cuda")
        n_params = sum(t.numel() for t in [
            params["embed"], params["lm_head"], params["final_norm"]]) + sum(
            t.numel() for layer in params["layers"] for t in layer.values())
        log(f"dims model [{label}]: {n_params / 1e6:.1f} M params, "
            f"{DIMS_LAYERS} layers, {cfg.n_q_heads}/{cfg.n_kv_heads} heads "
            f"of {cfg.d_head} (group {cfg.group})")
        for fmt, ps in (("bf16", ps16), ("int8", ps8)):
            run = dims_engine_run(label, cfg, params, fmt, ps, seed)
            for key, n in run["launches"].items():
                totals[key] = totals.get(key, 0) + n
                mine[key] = mine.get(key, 0) + n
            table, lengths = run["engine"].cache.device_views()
            if fmt == "bf16":
                q = randn((8, cfg.n_q_heads, cfg.d_head), torch.bfloat16, gen)
                caches[label] = check_decode(
                    f"dims: {label} engine cache, layer 0", q,
                    run["engine"].cache.pages[0], lengths, table, ps,
                    faults=True)
            elif not decode_compiled(cfg.d_head, ps):
                int8_caches[label] = check_decode(
                    f"dims: {label} int8 engine cache, layer 0", q,
                    run["engine"].cache.pages[0], lengths, table, ps,
                    faults=True)
            if cfg.d_head >= 256:
                wide[fmt] = wide_decode_groups(
                    label, fmt, run["engine"].cache.pages[0], lengths, table,
                    ps, gen, groups=(1, 2, 8) if cfg.d_head == 256
                    else WIDER_DECODE_GROUPS)
            del run
        del params
    for label, fields, *_ in models or DIMS_MODELS:
        if train and label in DIMS_TRAIN:
            train_pair(label, fields, gen, totals, by_model)
    return {"launches": totals, "by_model": by_model, "caches": caches,
            "int8_caches": int8_caches, "wide": wide}


# --- decode widths: every head_dim up to 256, every page size JAX takes ------

# B4, B12 and B5 at head dims without an instance of their own and page
# sizes the compiled widths do not take (the run-time width instances,
# ops/dims.py::decode_width): every (head_dim, page size) of these, the
# group 1, 3 and 8 by turn; int8 pages where JAX's page rule admits the pair
WIDTH_DIMS = (8, 36, 48, 72, 100, 112, 160, 192, 248)
WIDTH_PAGE_SIZES = (1, 8, 24, 48, 100)
WIDTH_GROUPS = (1, 3, 8)
# a table's capacity in tokens: at least 3 splits at every page size (512
# tokens of whole pages a split)
WIDTH_TOKENS = 1100
# the ring-mode case: head_dim 100 over pages of 48, a window of 300
WIDTH_RING = (100, 48, 300)
# The run-time widths timed at OpenLLaMA-3B's decode (8 sequences of
# 512-2048 tokens, 32 kv heads, group 1) beside the compiled instances at
# the nearest widths, over the same lengths: (label, head_dim, page size,
# page format)
WIDTH_TIMED = [
    ("d 100 ps 48, width 128", 100, 48, "bf16"),
    ("d 96 ps 64, compiled 96", 96, 64, "bf16"),
    ("d 128 ps 64, compiled 128", 128, 64, "bf16"),
    ("d 128 ps 48, width 128", 128, 48, "bf16"),
    ("d 100 ps 1, width 128", 100, 1, "bf16"),
    ("int8 d 100 ps 100, width 128", 100, 100, "int8"),
    ("int8 d 96 ps 64, compiled 96", 96, 64, "int8"),
]


def width_cases() -> list:
    """(head_dim, page size, group) of the decode-widths phase."""
    pairs = [(d, ps) for d in WIDTH_DIMS for ps in WIDTH_PAGE_SIZES]
    return [(d, ps, WIDTH_GROUPS[i % len(WIDTH_GROUPS)])
            for i, (d, ps) in enumerate(pairs)]


def openllama_lengths(seed) -> list:
    """8 decode lengths of 512-2048 tokens, from the seed."""
    rng = np.random.default_rng(seed)
    return sorted(int(n) for n in rng.integers(512, 2049, 8))


def decode_widths_phase(gen) -> dict:
    """B4 (bf16 q over bf16 pages, f32 over f32, bf16 over int8), B12 (bf16,
    f32) and B5 (into bf16, f32 and int8 pages) at every case of
    width_cases(), each against its plain version: the decodes at the
    decode gates against the plain version at the kernel's splits and
    unsplit, and on the run-time width instances (their launch count), the
    append bit for bit; B4's ring mode at WIDTH_RING (bf16, int8 pages).
    Then B12 on its path, the package surface, at OpenLLaMA-3B's widths
    (head_dim 100, page size 48; the count zeroed just before, read just
    after), and B4 at WIDTH_TIMED and B5 at head_dim 100 beside their
    bounds and the compiled instances at the nearest width. Returns the
    worst errors by kernel, B12's launches and the rows."""
    from tiny_flash_attention_tpu_torch.ops.dims import decode_compiled
    from tiny_flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_plain)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention,
        fused_paged_decode_plain, kernel_page_size, pack_paged_cache,
        page_append_plain)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    worst, cases, failed = {}, {}, []

    def note(kernel, case, errs, ok):
        cases[kernel] = cases.get(kernel, 0) + 1
        worst[kernel] = [max(a, b) for a, b in zip(
            worst.get(kernel, [0.0] * len(errs)), errs)]
        if not ok:
            failed.append((kernel, case, errs))

    def decode_case(kernel, fn, plain, width_count, case):
        before = width_count()
        out, lse = fn()
        torch.cuda.synchronize()
        err, row, lse_err, ok = split_errs(out, lse, plain)
        note(kernel, case, (err, row, lse_err),
             ok and width_count() == before + (not decode_compiled(
                 case[0], case[1])))

    fused_widths = lambda: fused_paged_decode_attention.width_launches
    t0 = time.perf_counter()
    for d, ps, group in width_cases():
        B, hkv = 4, 2
        P = -(-WIDTH_TOKENS // ps)
        num_pages = B * P + 3
        table = torch.randperm(num_pages, generator=gen, device="cuda")[
            :B * P].reshape(B, P).to(torch.int32)
        lengths = torch.tensor([1, ps, WIDTH_TOKENS // 2 + 7, P * ps],
                               dtype=torch.int32, device="cuda")
        sc = d ** -0.5
        case = (d, ps, group)
        for fmt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32),
                           ("int8", torch.bfloat16)):
            page_fmt = "int8" if fmt == "int8" else "bf16"
            if not kernel_page_size(ps, d, page_fmt):
                continue
            q = randn((B, hkv * group, d), dtype, gen)
            pages = pack_paged_cache(
                randn((hkv, num_pages, ps, d), dtype, gen),
                randn((hkv, num_pages, ps, d), dtype, gen), page_fmt)
            decode_case(
                f"B4 {fmt}",
                lambda: fused_paged_decode_attention(q, pages, lengths,
                                                     table, page_size=ps),
                lambda sp: fused_paged_decode_plain(
                    q, pages, lengths, table, page_size=ps, sm_scale=sc,
                    splits=sp), fused_widths, case)
            apages, k_new, v_new, ids, rows = append_inputs(
                gen, fmt=page_fmt, ps=ps, d=d, P=2, dtype=dtype)
            want = page_append_plain(apages.clone(), k_new, v_new, ids, rows,
                                     page_size=ps)
            got = fused_page_append(apages, k_new, v_new, ids, rows,
                                    page_size=ps)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            note(f"B5 {fmt}", case, (0.0 if same else max_err(got, want),),
                 same)
        for fmt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q = randn((B, hkv * group, d), dtype, gen)
            k, v = (randn((hkv, num_pages, ps, d), dtype, gen)
                    for _ in range(2))
            decode_case(
                f"B12 {fmt}",
                lambda: paged_decode_attention(q, k, v, lengths, table),
                lambda sp: paged_decode_plain(q, k, v, lengths, table,
                                              sm_scale=sc, splits=sp),
                lambda: paged_decode_attention.width_launches, case)
    # the ring mode over a wrapped table
    d, ps, window = WIDTH_RING
    B, hkv, P = 4, 2, -(-WIDTH_TOKENS // ps)
    num_pages = B * P + 3
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([1, window - 1, P * ps + 9, 3 * P * ps + 5],
                           dtype=torch.int32, device="cuda")
    for fmt in ("bf16", "int8"):
        q = randn((B, hkv * 3, d), torch.bfloat16, gen)
        pages = pack_paged_cache(
            randn((hkv, num_pages, ps, d), torch.bfloat16, gen),
            randn((hkv, num_pages, ps, d), torch.bfloat16, gen), fmt)
        decode_case(
            f"B4 {fmt} ring",
            lambda: fused_paged_decode_attention(
                q, pages, lengths, table, page_size=ps, window=window),
            lambda sp: fused_paged_decode_plain(
                q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
                window=window, splits=sp), fused_widths, (d, ps, 3))
    for kernel in cases:
        names = (("out", "row", "lse") if len(worst[kernel]) == 3
                 else ("max abs err",))
        log(f"decode widths {kernel}: {cases[kernel]} cases (head dims "
            f"{WIDTH_DIMS} x page sizes {WIDTH_PAGE_SIZES}, groups "
            f"{WIDTH_GROUPS}); worst "
            + ", ".join(f"{n} {x:.3e}" for n, x in zip(names,
                                                        worst[kernel]))
            + (f" (gates {DECODE_OUT_GATE:.0e}, {DECODE_ROW_GATE:.4e}, "
               f"{DECODE_LSE_GATE:.0e}; split and unsplit plain)"
               if len(names) == 3 else " (bit for bit)"))
    log(f"decode widths: {sum(cases.values())} kernel calls against their "
        f"plain versions in {time.perf_counter() - t0:.1f} s, "
        f"{len(failed)} failed"
        + "".join(f"; FAIL {k} (d, ps, group) {c}: {e}"
                  for k, c, e in failed[:20]))
    if failed:
        raise AssertionError(f"decode widths: {len(failed)} cases disagree "
                             f"with their plain versions")

    # B12 on its path, the package surface, at OpenLLaMA-3B's widths
    lens = openllama_lengths(SEED)
    q, k, v, lengths, table = b12_inputs(gen, "bf16", lens, hq=32, hkv=32,
                                         d=100, ps=48, P=-(-2048 // 48))
    # ---- the main path: counts zeroed just before, read just after ----
    paged_decode_attention.launches = 0
    paged_decode_attention.width_launches = 0
    torch.cuda.synchronize()
    out, lse = paged_decode_attention(q, k, v, lengths, table)
    torch.cuda.synchronize()
    b12_launches = paged_decode_attention.width_launches
    # ---------------------------------------------------------------------
    if (b12_launches, paged_decode_attention.launches) != (1, 1):
        raise AssertionError(f"B12 at head_dim 100 launched "
                             f"{b12_launches} run-time width instances")
    plain = (lambda sp: paged_decode_plain(q, k, v, lengths, table,
                                           sm_scale=100 ** -0.5, splits=sp))
    err, row, lse_err, ok = split_errs(out, lse, plain)
    check_v_faults("separate, OpenLLaMA-3B widths", b12_faults(
        q, k, v, lengths, table), plain)
    t_kernel = cuda_time_ms(lambda: paged_decode_attention(
        q, k, v, lengths, table), iters=20)["median_ms"]
    t_plain = cuda_time_ms(lambda: paged_decode_plain(
        q, k, v, lengths, table, sm_scale=100 ** -0.5), iters=5)["median_ms"]
    bound_ms, bound_by = decode_bound(q, k, lengths, table, 48)
    q96, k96, v96, _, table96 = b12_inputs(gen, "bf16", lens, hq=32, hkv=32,
                                           d=96, ps=64, P=32)
    t96 = cuda_time_ms(lambda: paged_decode_attention(
        q96, k96, v96, lengths, table96), iters=20)["median_ms"]
    log(f"decode widths: B12 at OpenLLaMA-3B widths q{tuple(q.shape)} pages "
        f"{tuple(k.shape)} lengths {lens} | launches {b12_launches} on the "
        f"run-time width instance | {gate_readings(err, row, lse_err)} | "
        f"kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms bound "
        f"{bound_ms:.4f} ms ({bound_by}) | the compiled 96 at ps 64 over "
        f"the same lengths {t96:.4f} ms | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("B12 at OpenLLaMA-3B widths disagrees with "
                             "plain")
    b12_row = {"max_abs_err": max(err, lse_err, *worst["B12 bf16"][::2],
                                  *worst["B12 f32"][::2]),
               "ms": t_kernel, "plain_ms": t_plain, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by}
    del q, k, v, q96, k96, v96

    # B4 at OpenLLaMA-3B's decode beside the compiled instances
    timed = {}
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for label, d, ps, fmt in WIDTH_TIMED:
        P = -(-2048 // ps)
        num_pages = 8 * P + 8
        table = torch.randperm(num_pages, generator=gen, device="cuda")[
            :8 * P].reshape(8, P).to(torch.int32)
        pages = pack_paged_cache(
            randn((32, num_pages, ps, d), torch.bfloat16, gen),
            randn((32, num_pages, ps, d), torch.bfloat16, gen), fmt)
        q = randn((8, 32, d), torch.bfloat16, gen)
        timed[label] = check_decode(f"widths: {label}, OpenLLaMA-3B's "
                                    f"decode", q, pages, lengths, table, ps,
                                    iters=20)
        del pages
    appends = {label: check_append(f"widths: {label}, 8 tokens x 32 kv "
                                   f"heads", fmt, ps, gen, d=d, hkv=32)
               for label, d, ps, fmt in (
                   ("d 100 ps 48", 100, 48, "bf16"),
                   ("d 96 ps 64", 96, 64, "bf16"),
                   ("int8 d 100 ps 100", 100, 100, "int8"),
                   ("int8 d 96 ps 64", 96, 64, "int8"))}
    return {"worst": worst, "b12_launches": b12_launches, "b12": b12_row,
            "timed": timed, "appends": appends}


def train_pair(label, fields, gen, totals, by_model,
               dtype=torch.bfloat16) -> None:
    """One AdamW step pair at a model's published widths (DIMS_LAYERS
    layers, 1 x 2048, in `dtype`) with the launches counted into totals
    and by_model; the loss falls and the gradients agree with those
    through the plain attention (TRAIN_GRAD_GATE; f32 TRAIN_F32_GRAD_GATE);
    peak device memory, beside the same pair padded where the head_dim is
    not a tile width."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops import dims
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd)
    from tiny_flash_attention_tpu_torch.parallel.train import make_train_step

    from tiny_flash_attention_tpu_torch.parallel.train import param_leaves

    cfg = T.ModelConfig(**fields, n_layers=DIMS_LAYERS, dtype=dtype)
    step, init_state = make_train_step(cfg, learning_rate=1e-3)
    params0 = T.init_params(cfg, gen, device="cuda")
    # the memory reckoned before the run: params0 (kept for the gradient
    # check), the step's copy, its gradients and AdamW's two moments, all
    # in the params' dtype; the reference path's f32 scores, one (heads,
    # 2048, 2048) tensor a layer
    n_params = sum(t.numel() for t in param_leaves(params0))
    el = torch.finfo(dtype).bits // 8
    scores = cfg.n_q_heads * 2048 ** 2 * 4
    log(f"dims train [{label}]: reckoned {n_params / 1e6:.1f} M params x "
        f"{el} bytes x 5 (params0, the step's copy, gradients, AdamW's two "
        f"moments) = {5 * n_params * el / 2**30:.2f} GiB; the reference "
        f"path's f32 scores {scores / 2**30:.2f} GiB a tensor a layer")
    params, opt = init_state(params0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(2):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    got = (flash_attention.launches, flash_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    totals["flash_fwd"] = totals.get("flash_fwd", 0) + got[0]
    totals["flash_bwd"] = totals.get("flash_bwd", 0) + got[1]
    mine = by_model[label]
    mine["flash_fwd"] = mine.get("flash_fwd", 0) + got[0]
    mine["flash_bwd"] = got[1]
    del params, opt
    if cfg.d_head in (*dims.FLASH_HEAD_DIMS, dims.WIDE_HEAD_DIM,
                      dims.WIDER_HEAD_DIM):
        log(f"dims train [{label}, 1 x 2048, {str(dtype).split('.')[-1]}]: "
            f"peak device memory of the pair {peak / 2**20:.1f} MiB "
            f"(head_dim {cfg.d_head}, a tile width: nothing pads)")
    else:
        # the same pair padded, from the same weights
        params, opt = init_state(params0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        padded_losses = []
        with padded_head_dims():
            for _ in range(2):
                params, opt, loss = step(params, opt, tokens)
                padded_losses.append(float(loss))
        padded_peak = torch.cuda.max_memory_allocated()
        del params, opt
        log(f"dims train [{label}, 1 x 2048]: peak device memory of the "
            f"pair {peak / 2**20:.1f} MiB read in place, "
            f"{padded_peak / 2**20:.1f} MiB padded "
            f"({(padded_peak - peak) / 2**20:.1f} MiB saved); the padded "
            f"pair's losses {padded_losses[0]:.4f} -> "
            f"{padded_losses[1]:.4f}, the same bits: "
            f"{padded_losses == losses}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    err = train_grad_check(cfg, params0, tokens)
    log(f"dims train [{label}]: peak device memory of the gradient check "
        f"(kernels, then attn_impl='reference') "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    grad_gate = (TRAIN_F32_GRAD_GATE if dtype == torch.float32
                 else TRAIN_GRAD_GATE)
    log(f"dims train [{label}, 1 x 2048, {str(dtype).split('.')[-1]}]: loss "
        f"{losses[0]:.4f} -> {losses[1]:.4f} in 2 steps ({dt * 1e3:.1f} "
        f"ms); {got[0]} forward and {got[1]} backward calls (expected "
        f"{2 * cfg.n_layers} each); gradients vs attn_impl='reference': "
        f"max relative Frobenius distance {err:.3e} (gate {grad_gate:.0e})")
    if got != (2 * cfg.n_layers,) * 2 or not (
            np.isfinite(losses).all() and losses[1] < losses[0]):
        raise AssertionError(f"dims train step: {got}, {losses}")
    if not err <= grad_gate:
        raise AssertionError("dims train gradients disagree with the plain "
                             "path")



# --- phase 10: head_dim 256 on the f32 path ----------------------------------

# Gemma-2B's attention in f32, the f32 prefill's and train step's per-layer
# shape at 1 x 2048: (q shape, kv shape)
WIDE_F32_SHAPE = ((1, 8, 2048, 256), (1, 1, 2048, 256))
# B1 f32 at 256 and at 192 (padded to 256) under each mask and group:
# (d, group, mask)
WIDE_F32_FLASH_CASES = [(256, 1, "window"), (256, 8, "ids"),
                        (256, 2, "causal"), (192, 8, "causal"),
                        (192, 1, "window"), (192, 2, "ids")]
# the calls of the f32 backward's bit-identity check at 256
WIDE_F32_BWD_REPEATS = 4
# an engine's page formats for an f32 model ("bf16" pages hold the model's
# dtype) as the log names them
F32_PAGES = {"bf16": "f32 pages", "int8": "int8 pages"}


def wide_f32_phase(gen) -> dict:
    """Every f32 kernel of the serving and training path at head_dim 256
    against its plain version: B1 f32 at Gemma-2B's (1,8,2048,256)/(1,1)
    causal, bit-identical over two calls, with planted faults (a stale V
    tile, a dropped kv tile, a lost run of the merge), timed beside SDPA
    in f32 (its backend named) and the bound; under each mask and group at
    256 and at 192 through the padded route (its copies counted); its
    jagged mode; the f32 backward at the same shape against its plain
    version and autograd, bit-identical over WIDE_F32_BWD_REPEATS more
    calls, timed beside SDPA's, and with the window at 192; B4's ring mode
    over f32 and int8 pages; B12 in f32; B5 into f32 and int8 pages bit
    for bit. (B4 over the Gemma-2B-width f32 engines' caches:
    wide_f32_model_phase.)"""
    from tiny_flash_attention_tpu_torch.ops import dims

    rows = {"errs": {}}
    errs = rows["errs"]
    rows["flash"] = check_flash("wide f32: B1 at the Gemma-2B f32 prefill",
                                *WIDE_F32_SHAPE, torch.float32, True, gen,
                                faults=True)
    q = randn(WIDE_F32_SHAPE[0], torch.float32, gen)
    k = randn(WIDE_F32_SHAPE[1], torch.float32, gen)
    log(f"wide f32: SDPA in f32 at q{WIDE_F32_SHAPE[0]} causal runs "
        + sdpa_kernel_name(lambda: F.scaled_dot_product_attention(
            q, k, k, is_causal=True, enable_gqa=True)))
    del q, k
    before = dims.pad_head_dim.copies
    errs["flash_fwd"] = max(check_dims_flash(*c, torch.float32, gen)
                            for c in WIDE_F32_FLASH_CASES)
    copies = dims.pad_head_dim.copies - before
    want = 3 * sum(c[0] != 256 for c in WIDE_F32_FLASH_CASES)
    log(f"wide f32: B1's calls at 192 pad q, k and v to 256, at 256 "
        f"nothing: {copies} copies (expected {want})")
    if copies != want:
        raise AssertionError(f"wide f32: {copies} pad copies, not {want}")
    errs["flash_fwd"] = max(errs["flash_fwd"], rows["flash"]["max_abs_err"],
                            check_rowloop(gen, d=256,
                                          dtypes=(torch.float32,)))
    rows["flash_bwd"] = check_bwd(
        "wide f32: backward at the Gemma-2B f32 train step",
        *WIDE_F32_SHAPE, torch.float32, True, {}, gen,
        repeats=WIDE_F32_BWD_REPEATS)
    errs["flash_bwd"] = max(
        rows["flash_bwd"]["max_abs_err"],
        check_bwd("wide f32: backward at 192, window 200",
                  (2, 4, 1000, 192), (2, 2, 1000, 192), torch.float32, True,
                  {"window": 200}, gen, iters=3)["max_abs_err"])
    ring = 0.0
    for fmt, group in (("bf16", 1), ("bf16", 8), ("int8", 2), ("int8", 8)):
        r = check_ring(f"wide f32: {F32_PAGES[fmt]} d 256 group {group}", fmt,
                       gen, hq=group, hkv=1, d=256, ps=128, P=16,
                       dtype=torch.float32)
        ring = max(ring, r["max_abs_err"])
    errs["ring"] = ring
    rows["b12"] = check_dims_b12(gen, d=256, hq=8, hkv=1,
                                 dtype=torch.float32)
    errs["paged_decode_separate"] = max(r["max_abs_err"]
                                        for r in rows["b12"].values())
    rows["append"] = {
        fmt: check_append(f"wide f32: {F32_PAGES[fmt]} d 256 ps 128, "
                          f"Gemma-2B's 8 tokens x 1 kv head", fmt, 128, gen,
                          d=256, hkv=1, iters=10, dtype=torch.float32)
        for fmt in ("bf16", "int8")}
    errs["page_append"] = max(r["max_abs_err"]
                              for r in rows["append"].values())
    return rows


def wide_f32_model_phase(seed) -> dict:
    """The Gemma-2B-width model (DIMS_MODELS) in f32, DIMS_LAYERS layers,
    random weights from the seed, TF32 off: served over f32 pages and over
    int8 pages (dims_engine_run at ENGINE_F32_LOGIT_GATE), B4 over each
    engine's cache with f32 q at groups 1, 2 and 8 (wide_decode_groups);
    then the f32 train step pair at 1 x 2048 (train_pair). Returns the
    launches of the engines and the pair by kernel, the pair's alone, and
    the decode rows by page format."""
    from tiny_flash_attention_tpu_torch.models import transformer as T

    label, fields, ps16, ps8 = DIMS_MODELS[2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = T.ModelConfig(**fields, n_layers=DIMS_LAYERS, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
    log(f"wide f32 model [{label}, f32]: {DIMS_LAYERS} layers, "
        f"{cfg.n_q_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}")
    launches, decode = {}, {}
    for fmt, ps in (("bf16", ps16), ("int8", ps8)):
        run = dims_engine_run(f"{label}, f32", cfg, params, fmt, ps, seed,
                              gate=ENGINE_F32_LOGIT_GATE)
        for key, n in run["launches"].items():
            launches[key] = launches.get(key, 0) + n
        table, lengths = run["engine"].cache.device_views()
        decode[fmt] = wide_decode_groups(
            f"{label}, f32", F32_PAGES[fmt], run["engine"].cache.pages[0],
            lengths, table, ps, gen, dtype=torch.float32)
        del run
    del params
    pair = {label: {}}
    train_pair(label, fields, gen, launches, pair, dtype=torch.float32)
    return {"launches": launches, "train": pair[label], "decode": decode}


# --- head dims 257-512: serving at DeepSeek-V4-Flash's attention widths -------

# B1 at head dims in (256, 512] read in place on the instance of width 512
# (264 and 392 off JAX's 128-lane tiles, 320 and 448 off the instance's
# 512) and groups 1, 8 and 64 (DeepSeek-V4-Flash's), each under one mask
# ("starts": the ids with their segment_starts); the jagged mode at 448:
# (d, group, mask)
WIDER_FLASH_CASES = [(264, 1, "causal"), (264, 8, "window"),
                     (264, 64, "starts"), (320, 8, "ids"),
                     (384, 1, "starts"), (384, 64, "window"),
                     (392, 8, "causal"), (448, 64, "causal"),
                     (512, 1, "window"), (512, 8, "starts"),
                     (512, 64, "ids")]
# B1 read in place beside the same call padded to 512 (bits; times in
# turns): (head_dim, (b, h, n), kv heads)
WIDER_IN_PLACE = [(264, (2, 8, 1024), 1), (392, (2, 8, 1024), 1),
                  (448, (2, 8, 1024), 1), (384, (4, 8, 2048), 1)]
# B1 timed beside SDPA and the bound: DeepSeek-V4-Flash's prefill at its
# engines' longest bucket (64 q heads over 1 kv head of 512) and a head_dim
# of 384 at Gemma-2B's prefill shape: (label, q shape, kv shape)
WIDER_FWD_SHAPES = [
    ("DeepSeek-V4-Flash prefill", (1, 64, 2048, 512), (1, 1, 2048, 512)),
    ("head_dim 384", (4, 8, 2048, 384), (4, 1, 2048, 384))]
# B4, B12 and B5 at these head dims x page sizes, the groups by turn
WIDER_DIMS = (300, 384, 512)
WIDER_PAGE_SIZES = (1, 48, 64, 128)
WIDER_GROUPS = (1, 8, 64)
# B4 over each DeepSeek-V4-Flash-width engine cache at these groups
WIDER_DECODE_GROUPS = (1, 8, 64)
# the sources the phase runs (`--wide` builds these alone)
WIDER_SOURCES = ["flash_fwd", "flash_bwd", "paged_decode_wide",
                 "paged_decode_separate_wide", "page_append"]
# the backward's instance of width 512 against its plain version at
# 1024 rows: every head_dim under each group and each mask by turn
# ("starts": ids changing at WIDER_BWD_BOUNDS with their segment_starts),
# the planted faults at 392: (d, group, mask)
WIDER_BWD_CASES = [(264, 1, "causal"), (264, 8, "window"),
                   (264, 64, "starts"), (384, 1, "starts"),
                   (384, 8, "causal"), (384, 64, "window"),
                   (392, 1, "window"), (392, 8, "starts"),
                   (392, 64, "causal"), (512, 1, "causal"),
                   (512, 8, "window"), (512, 64, "starts")]
WIDER_BWD_BOUNDS = (300, 610)
WIDER_BWD_WINDOW = 200
# the backward read in place beside the call padded to 512 (bits, no copy;
# times in turns): (head_dim, (b, h, n), kv heads)
WIDER_IN_PLACE_BWD = [(264, (1, 8, 2048), 1), (392, (1, 8, 2048), 1)]
# the backward timed beside SDPA's (K/V repeated) and the bound:
# DeepSeek-V4-Flash's train step (a layer at 1 x 2048) and head_dim 384 at
# Gemma-2B's prefill shape: (label, q shape, kv shape)
WIDER_BWD_SHAPES = [
    ("DeepSeek-V4-Flash train step", (1, 64, 2048, 512), (1, 1, 2048, 512)),
    ("head_dim 384", (4, 8, 2048, 384), (4, 1, 2048, 384))]


def wider_instances() -> None:
    """The new instances' build: B1's and the backward's of width 512 on
    wgmma (HGMMA in their SASS, no HMMA) with their registers and spill
    bytes (the backward's prep and post too), and every instance of the
    width-512 decode sources (ptxas)."""
    from tiny_flash_attention_tpu_torch import _build

    sass = {k: v for k, v in wgmma_instructions(
        str(_build._target("flash_fwd")[1])).items()
        if k.startswith("flash_fwd_wgmma_kernel<512,")}
    regs = [x for x in instance_registers(_build.build_log("flash_fwd"))
            if x.startswith("flash_fwd_wgmma_kernel<512,")]
    log(f"wider: flash_fwd's width-512 instances, HGMMA/HMMA (cuobjdump "
        f"-sass): " + ", ".join(f"{k}: {g}/{h}" for k, (g, h) in
                                sass.items())
        + "; registers/spill bytes: " + ", ".join(regs))
    if len(sass) != 4 or any(g == 0 or h > 0 for g, h in sass.values()):
        raise AssertionError("B1's width-512 instances are not on wgmma")
    sass = {k: v for k, v in wgmma_instructions(
        str(_build._target("flash_bwd")[1])).items()
        if k.startswith("flash_bwd_512_kernel<512,")}
    regs = [x for x in instance_registers(_build.build_log("flash_bwd"))
            if "<512" in x]
    log(f"wider: flash_bwd's width-512 main instances, HGMMA/HMMA "
        f"(cuobjdump -sass): " + ", ".join(f"{k}: {g}/{h}" for k, (g, h) in
                                           sass.items())
        + "; prep, main and post registers/spill bytes: " + ", ".join(regs))
    if len(sass) != 4 or any(g == 0 or h > 0 for g, h in sass.values()):
        raise AssertionError("the backward's width-512 instances are not "
                             "on wgmma")
    for name in WIDER_SOURCES[2:4]:
        log(f"wider: {name} registers/spill bytes: " + "; ".join(
            spilling_instances(_build.build_log(name), every=True)))


def sdpa_expanded(name, q_shape, kv_shape, iters=5) -> dict:
    """SDPA causal with K and V repeated to q's heads (no enable_gqa, so
    that its memory-efficient backend may run), timed on inputs of the
    given shapes, with the device kernel it ran: a second library
    yardstick beside check_flash's (enable_gqa=True). Its inputs, timed
    only, come from a generator of their own, so the phase's draws after
    it are as without it. Returns its ms and kernel."""
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = randn(q_shape, torch.bfloat16, gen)
    rep = q_shape[1] // kv_shape[1]
    k, v = (randn(kv_shape, torch.bfloat16, gen).repeat_interleave(rep, 1)
            for _ in range(2))

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    t = cuda_time_ms(sdpa, iters=iters)["median_ms"]
    ran = sdpa_kernel_name(sdpa)
    log(f"flash {name}: SDPA with K/V repeated to {q_shape[1]} heads (no "
        f"enable_gqa) {t:.4f} ms ({ran})")
    return {"library_expanded_ms": t, "library_expanded": ran}


def wider_grid(gen) -> dict:
    """B4 (bf16 and int8 pages), B12 (bf16 pages, int8 at page size 128)
    and B5 (bf16, f32 and int8 pages) at WIDER_DIMS x WIDER_PAGE_SIZES, the
    groups of WIDER_GROUPS by turn, against their plain versions: the
    decodes at the decode gates (split and unsplit plain) and on the
    run-time width instances where the pair is not compiled (their launch
    counts), the append bit for bit. Returns the worst errors by kernel and
    the checked calls' launches. The decodes' absolute out gate is
    spaced_split_errs' (one bf16 ulp of |plain| where out rounds the f32
    model); the elements past DECODE_OUT_GATE and the witness are logged."""
    from tiny_flash_attention_tpu_torch.ops.dims import decode_compiled
    from tiny_flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_plain)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention,
        fused_paged_decode_plain, pack_paged_cache, page_append_plain)
    from tiny_flash_attention_tpu_torch.ops.quant import quantize_int8

    worst, cases, failed, launches, over = {}, {}, [], {}, {}
    t0 = time.perf_counter()
    pairs = [(d, ps) for d in WIDER_DIMS for ps in WIDER_PAGE_SIZES]
    for i, (d, ps) in enumerate(pairs):
        group = WIDER_GROUPS[i % len(WIDER_GROUPS)]
        B, hkv = 4, 2
        P = -(-WIDTH_TOKENS // ps)
        num_pages = B * P + 3
        table = torch.randperm(num_pages, generator=gen, device="cuda")[
            :B * P].reshape(B, P).to(torch.int32)
        lengths = torch.tensor([1, ps, WIDTH_TOKENS // 2 + 7, P * ps],
                               dtype=torch.int32, device="cuda")
        sc, case = d ** -0.5, (d, ps, group)
        runtime = not decode_compiled(d, ps)

        def decode(kernel, fn, plain, counter):
            before = (counter.launches
                      + getattr(counter, "int8_launches", 0),
                      counter.width_launches)
            out, lse = fn()
            torch.cuda.synchronize()
            err, row, lse_err, n_over, witness, ok = spaced_split_errs(
                out, lse, plain)
            if n_over:
                n, w = over.get(kernel, (0, 0.0))
                over[kernel] = (n + n_over, max(w, witness))
                log(f"wider {kernel} (d, ps, group) {case}: {n_over} "
                    f"elements past {DECODE_OUT_GATE:.0e}, out err "
                    f"{err:.4e}; |out - f32 model| at most {witness:.3f} "
                    f"of its bf16 ulp | {'ok' if ok else 'FAIL'}")
            after = (counter.launches + getattr(counter, "int8_launches", 0),
                     counter.width_launches)
            ok = ok and after == (before[0] + 1, before[1] + runtime)
            launches[kernel] = launches.get(kernel, 0) + 1
            cases[kernel] = cases.get(kernel, 0) + 1
            worst[kernel] = [max(a, b) for a, b in zip(
                worst.get(kernel, [0.0] * 3), (err, row, lse_err))]
            if not ok:
                failed.append((kernel, case, (err, row, lse_err)))

        q = randn((B, hkv * group, d), torch.bfloat16, gen)
        kp, vp = (randn((hkv, num_pages, ps, d), torch.bfloat16, gen)
                  for _ in range(2))
        for fmt in ("bf16", "int8"):
            pages = pack_paged_cache(kp, vp, fmt)
            decode(f"B4 {fmt}",
                   lambda: fused_paged_decode_attention(
                       q, pages, lengths, table, page_size=ps),
                   lambda sp, dt=None: fused_paged_decode_plain(
                       q, pages, lengths, table, page_size=ps, sm_scale=sc,
                       splits=sp, out_dtype=dt), fused_paged_decode_attention)
            del pages
        for fmt in ("bf16", "int8") if ps % 128 == 0 else ("bf16",):
            k, v = ((quantize_int8(x, axis=-1) for x in (kp, vp))
                    if fmt == "int8" else (kp, vp))
            decode(f"B12 {fmt}",
                   lambda: paged_decode_attention(q, k, v, lengths, table),
                   lambda sp, dt=None: paged_decode_plain(
                       q, k, v, lengths, table, sm_scale=sc, splits=sp,
                       out_dtype=dt), paged_decode_attention)
        for fmt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32),
                           ("int8", torch.bfloat16)):
            page_fmt = "int8" if fmt == "int8" else "bf16"
            apages, k_new, v_new, ids, rows = append_inputs(
                gen, fmt=page_fmt, ps=ps, d=d, P=2, dtype=dtype)
            want = page_append_plain(apages.clone(), k_new, v_new, ids, rows,
                                     page_size=ps)
            got = fused_page_append(apages, k_new, v_new, ids, rows,
                                    page_size=ps)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            kernel = f"B5 {fmt}"
            launches[kernel] = launches.get(kernel, 0) + 1
            cases[kernel] = cases.get(kernel, 0) + 1
            worst[kernel] = [max(worst.get(kernel, [0.0])[0],
                                 0.0 if same else max_err(got, want))]
            if not same:
                failed.append((kernel, case, worst[kernel]))
        del q, kp, vp
    for kernel in cases:
        names = (("out", "row", "lse") if len(worst[kernel]) == 3
                 else ("max abs err",))
        log(f"wider {kernel}: {cases[kernel]} cases (head dims {WIDER_DIMS} "
            f"x page sizes {WIDER_PAGE_SIZES}, groups {WIDER_GROUPS} by "
            f"turn); worst " + ", ".join(
                f"{n} {x:.3e}" for n, x in zip(names, worst[kernel]))
            + (f" (gates {DECODE_OUT_GATE:.0e} or one bf16 ulp of "
               f"|plain| where out rounds the f32 model, "
               f"{DECODE_ROW_GATE:.4e}, {DECODE_LSE_GATE:.0e}; split and "
               f"unsplit plain); past {DECODE_OUT_GATE:.0e}: "
               f"{over.get(kernel, (0, 0.0))[0]} elements, |out - f32 "
               f"model| at most {over.get(kernel, (0, 0.0))[1]:.3f} ulp"
               if len(names) == 3 else " (bit for bit)"))
    log(f"wider: {sum(cases.values())} kernel calls against their plain "
        f"versions in {time.perf_counter() - t0:.1f} s, {len(failed)} "
        f"failed" + "".join(f"; FAIL {k} (d, ps, group) {c}: {e}"
                            for k, c, e in failed[:20]))
    if failed:
        raise AssertionError(f"wider: {len(failed)} decode or append cases "
                             f"disagree with their plain versions")
    return {"worst": worst, "launches": launches}


def wider_bwd_phase(gen) -> dict:
    """The training path's kernels at head dims in (256, 512]: the bf16
    backward's instance of width 512 against its plain version and f32
    autograd at WIDER_BWD_CASES (check_bwd's gates at 256; planted faults
    at 392: a scale from 512, an epilogue storing all 512 columns), read in
    place beside the call padded to 512 at WIDER_IN_PLACE_BWD (bits, no
    copy; times in turns), its spread at 512 (0 of the pairs may differ),
    and timed at WIDER_BWD_SHAPES beside SDPA's backward (K/V repeated, its
    backend named) and the bound. Returns the timed rows, the in-place
    rows and the worst error."""
    worst = 0.0
    for d, group, mask in WIDER_BWD_CASES:
        hkv = 2 if group == 1 else 1
        masks = {"window": {"window": WIDER_BWD_WINDOW},
                 "starts": {"bounds": WIDER_BWD_BOUNDS, "starts": True}
                 }.get(mask, {})
        r = check_bwd(f"wider: backward d {d} group {group} {mask}",
                      (1, hkv * group, 1024, d), (1, hkv, 1024, d),
                      torch.bfloat16, True, masks, gen, iters=2,
                      faults=d == 392)
        worst = max(worst, r["max_abs_err"])
    in_place = {d: in_place_bwd(d, gen, shape=shape, hkv=hkv)
                for d, shape, hkv in WIDER_IN_PLACE_BWD}
    bwd_spread(gate=True, d=512)
    timed = {label: check_bwd(f"wider: backward at {label}", q_shape,
                              kv_shape, torch.bfloat16, True, {}, gen,
                              iters=5)
             for label, q_shape, kv_shape in WIDER_BWD_SHAPES}
    worst = max(worst, *(r["max_abs_err"] for r in timed.values()))
    return {"timed": timed, "in_place": in_place, "worst": worst}


def wider_phase(gen) -> dict:
    """The serving path at head dims in (256, 512], each kernel against its
    plain version: B1 (bf16 over bf16 K/V, the instance of width 512) at
    WIDER_FLASH_CASES with planted faults at 392 (a scale from 512, an
    epilogue storing all 512 columns), the jagged mode at 448, in place
    beside the call padded to 512 (bits, no copy; times in turns) at
    WIDER_IN_PLACE, timed at WIDER_FWD_SHAPES beside SDPA (its backend
    named) and the bound with B1's planted faults at V4-Flash's prefill;
    B4, B12 and B5 over the grid (wider_grid), B4's ring mode at 512
    (groups 1 and 64 over bf16 pages, 8 over int8), B12 at group 64 over
    8 sequences up to 8192 tokens with its planted faults, B5 timed at
    V4-Flash's 8 tokens x 1 kv head; then the DeepSeek-V4-Flash-width
    engines (dims_model_phase: bf16 pages of 64, int8 pages of 128, B4
    over each cache at WIDER_DECODE_GROUPS); the training path, on a
    generator of its own (so the serving checks take the inputs they
    always took): the backward's instance of width 512 (wider_bwd_phase)
    and the DeepSeek-V4-Flash-width train step pair (in dims_model_phase).
    Returns the rows, the worst errors and the engines' and the train
    pair's launches."""
    wider_instances()
    rows, errs = {}, {}
    errs["flash_fwd"] = max(check_dims_flash(*c, torch.bfloat16, gen)
                            for c in WIDER_FLASH_CASES)
    errs["flash_fwd"] = max(errs["flash_fwd"], check_rowloop(
        gen, d=448, dtypes=(torch.bfloat16,)))
    rows["in_place"] = {d: in_place_fwd(d, gen, shape=shape, hkv=hkv)
                        for d, shape, hkv in WIDER_IN_PLACE}
    rows["flash"] = {label: check_flash(
        f"wider: B1 at {label}", q_shape, kv_shape, torch.bfloat16, True,
        gen, iters=5, faults=q_shape[-1] == 512)
        for label, q_shape, kv_shape in WIDER_FWD_SHAPES}
    for label, q_shape, kv_shape in WIDER_FWD_SHAPES:
        rows["flash"][label].update(sdpa_expanded(
            f"wider: B1 at {label}", q_shape, kv_shape))
    errs["flash_fwd"] = max(errs["flash_fwd"], *(
        r["max_abs_err"] for r in rows["flash"].values()))
    grid = wider_grid(gen)
    rows["grid_launches"] = grid["launches"]
    ring = {}
    for fmt, group in (("bf16", 1), ("bf16", 64), ("int8", 8)):
        ring[(fmt, group)] = check_ring(
            f"wider: {fmt} d 512 group {group}", fmt, gen, hq=group, hkv=1,
            d=512, ps=128, P=16)
    rows["b12"] = check_dims_b12(gen, d=512, hq=64, hkv=1)
    rows["append"] = {
        (fmt, ps): check_append(f"wider: {fmt} d 512 ps {ps}, "
                                f"DeepSeek-V4-Flash's 8 tokens x 1 kv head",
                                fmt, ps, gen, d=512, hkv=1, iters=10)
        for fmt, ps in (("bf16", 64), ("int8", 128))}
    worst = grid["worst"]
    errs["paged_decode"] = max(
        *worst["B4 bf16"][::2], *(r["max_abs_err"] for (f, _), r in
                                  ring.items() if f == "bf16"))
    errs["paged_decode_int8"] = max(*worst["B4 int8"][::2],
                                    ring[("int8", 8)]["max_abs_err"])
    errs["paged_decode_separate"] = max(
        *worst["B12 bf16"][::2], *worst["B12 int8"][::2],
        *(r["max_abs_err"] for r in rows["b12"].values()))
    errs["page_append"] = max(
        *(worst[f"B5 {f}"][0] for f in ("bf16", "f32", "int8")),
        *(r["max_abs_err"] for r in rows["append"].values()))
    rows["runtime"] = wider_runtime_timed(gen)
    bwd = wider_bwd_phase(torch.Generator(device="cuda").manual_seed(
        SEED + 4))
    rows["bwd"], rows["in_place_bwd"] = bwd["timed"], bwd["in_place"]
    errs["flash_bwd"] = bwd["worst"]
    models = dims_model_phase(SEED, models=[m for m in DIMS_MODELS
                                            if m[0] == V4_MODEL])
    return {"rows": rows, "errs": errs, "models": models}


def wider_runtime_timed(gen) -> dict:
    """B4 and B12 on the run-time width-512 instance (head_dim 384) beside
    the compiled 512, over the same lengths (the DeepSeek-V4-Flash-width
    engines' 8 caches after their 64 steps) and page tables, 1 kv head:
    B4 over bf16 pages of 64 and int8 pages of 128 at groups 1 and 64, B12
    at group 64 over bf16 pages of 64 and int8 pages of 128; each against
    its plain version at the decode gates, timed beside its bound, with
    the run-time width launches of the timed calls. Returns the rows by
    (kernel, format, group, head_dim)."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_plain)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_attention, pack_paged_cache)
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)

    fields = next(m[1] for m in DIMS_MODELS if m[0] == V4_MODEL)
    # the prompts and the 64 steps (two steps(32) chunks) of dims_engine_run
    lens = [len(p) + 64 for p in serve_prompts(T.ModelConfig(
        **fields, n_layers=1))]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = {}
    for fmt, ps in (("bf16", 64), ("int8", 128)):
        P = -(-2048 // ps)
        num_pages = 8 * P + 8
        table = torch.randperm(num_pages, generator=gen, device="cuda")[
            :8 * P].reshape(8, P).to(torch.int32)
        for d in (384, 512):
            pages = pack_paged_cache(
                randn((1, num_pages, ps, d), torch.bfloat16, gen),
                randn((1, num_pages, ps, d), torch.bfloat16, gen), fmt)
            for group in (1, 64):
                q = randn((8, group, d), torch.bfloat16, gen)
                width = fused_paged_decode_attention.width_launches
                row = check_decode(f"wider: B4 {fmt} d {d} ps {ps} group "
                                   f"{group}, V4-Flash's cache lengths", q,
                                   pages, lengths, table, ps, iters=10)
                row["width_launches"] = (
                    fused_paged_decode_attention.width_launches - width)
                rows[("B4", fmt, group, d)] = row
            del pages
        for d in (384, 512):
            q, k, v, _, b12_table = b12_inputs(
                gen, fmt, lens, hq=64, hkv=1, d=d, ps=ps, P=P)
            width = paged_decode_attention.width_launches
            out, lse = paged_decode_attention(q, k, v, lengths, b12_table)
            torch.cuda.synchronize()
            err, row_e, lse_err, ok = split_errs(out, lse, (
                lambda sp: paged_decode_plain(q, k, v, lengths, b12_table,
                                              sm_scale=d ** -0.5,
                                              splits=sp)))
            t_kernel = cuda_time_ms(lambda: paged_decode_attention(
                q, k, v, lengths, b12_table), iters=10)["median_ms"]
            t_plain = cuda_time_ms(lambda: paged_decode_plain(
                q, k, v, lengths, b12_table, sm_scale=d ** -0.5),
                iters=5)["median_ms"]
            kv = k.values if fmt == "int8" else k
            bound_ms, bound_by = decode_bound(q, kv, lengths, b12_table, ps)
            launched = paged_decode_attention.width_launches - width
            log(f"wider: B12 {fmt} d {d} ps {ps} group 64, V4-Flash's "
                f"cache lengths {lens} | {gate_readings(err, row_e, lse_err)}"
                f" | kernel {t_kernel:.4f} ms plain {t_plain:.4f} ms bound "
                f"{bound_ms:.4f} ms ({bound_by}) | {launched} launches on "
                f"the run-time width | {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"B12 disagrees at head_dim {d}")
            rows[("B12", fmt, 64, d)] = {
                "max_abs_err": max(err, lse_err), "ms": t_kernel,
                "plain_ms": t_plain, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "width_launches": launched}
            del q, k, v
    for key in sorted({k[:3] for k in rows}):
        at = {d: rows[(*key, d)] for d in (384, 512)}
        log(f"wider: {key[0]} {key[1]} group {key[2]} over V4-Flash's "
            f"cache lengths: run-time width 512 (d 384) "
            f"{at[384]['ms']:.4f} ms ({at[384]['width_launches']} run-time "
            f"launches), compiled 512 {at[512]['ms']:.4f} ms "
            f"({at[512]['width_launches']}): "
            f"{at[384]['ms'] / at[512]['ms']:.2f}x")
    if any((rows[k]["width_launches"] > 0) != (k[3] == 384) for k in rows):
        raise AssertionError("wider: the run-time and compiled width-512 "
                             "decodes did not run where expected")
    return rows


# --- context parallel: ring, zigzag ring, Ulysses, all-gather, sharded -------
# Llama-3.2-3B's attention widths (DIMS_MODELS[1]: 24 q / 8 kv heads of 128,
# bf16). Worlds of 2 and 4 ranks share the one card over gloo (NCCL refuses
# two ranks on one card), which moves host memory: their times are of ranks
# time-sharing one card, not a context-parallel speed over NVLink. A world
# of 1 on NCCL runs every mode on the NCCL code path at CP_SHORT_SEQ (at
# n = 1 the merge is exact at any length).
CP_HEADS = (24, 8)
CP_SEQ = 32768            # 8192 tokens a rank at n = 4
CP_ALLGATHER_SEQ = 16384
CP_SHARDED = (2, 4096)    # batch x seq on a (data 2, model 2) mesh
CP_SHORT_SEQ = 2048
CP_TIMEOUT_S = 300.0


def cp_case(mode, causal, seq, *, batch=1, mesh=None, faults=()):
    """One case of the phase: `mesh` (data, model) defaults to (1, n)."""
    return {"mode": mode, "causal": causal, "shape": (batch, *CP_HEADS, seq,
                                                      128),
            "mesh": mesh, "faults": tuple(faults)}


def cp_expected_launches(case, ctx_index: int, n: int) -> int:
    """Flash launches of one rank: causal ring i + 1 (rank i's blocks up to
    its own), non-causal ring n, zigzag n + 1 (two at the diagonal step),
    Ulysses, all-gather and sharded 1."""
    if case["mode"] == "ring":
        return ctx_index + 1 if case["causal"] else n
    if case["mode"] == "zigzag":
        return n + 1 if n > 1 else 1
    return 1


def _cp_fn(case, mesh):
    from tiny_flash_attention_tpu_torch.parallel import ring as R
    from tiny_flash_attention_tpu_torch.parallel.sharded import (
        shard_map, sharded_flash_attention)

    mode, causal = case["mode"], case["causal"]
    if mode == "ring":
        return R.ring_attention_sharded(mesh, causal=causal)
    if mode == "zigzag":
        return R.zigzag_ring_attention_sharded(mesh)
    if mode == "ulysses":
        return R.ulysses_attention_sharded(mesh, causal=causal)
    if mode == "allgather":
        # JAX's module has the local function only: its shard_map here
        return shard_map(R.make_allgather_attention(mesh, axis_name="model"),
                         mesh, ("data", None, "model", None))
    return sharded_flash_attention(mesh, causal=causal)


@contextlib.contextmanager
def _cp_timed_flash(times: list):
    """Patches the flash entry the parallel modules call with one that
    records CUDA events around each call (one launch each)."""
    from tiny_flash_attention_tpu_torch.parallel import ring as R
    from tiny_flash_attention_tpu_torch.parallel import sharded as S

    real = R.flash_attention

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        times.append((start, end))
        return out

    R.flash_attention = S.flash_attention = timed
    try:
        yield
    finally:
        R.flash_attention = S.flash_attention = real


@contextlib.contextmanager
def _cp_fault(fault: str):
    """A planted fault on every rank: "reversed" rotates the ring the wrong
    way, "dropped merge" drops each rank's second merge; "no unpermute" is
    applied by the caller (the zigzag output left in zigzag order)."""
    from tiny_flash_attention_tpu_torch.parallel import comm
    from tiny_flash_attention_tpu_torch.parallel import ring as R

    real_rotation, real_merge = comm.Rotation, R._merge
    calls = []

    def reversed_rotation(tensors, group, shift=1):
        return real_rotation(tensors, group, -shift)

    def dropped_merge(o, lse, o_i, lse_i):
        calls.append(1)
        return (o, lse) if len(calls) == 2 else real_merge(o, lse, o_i, lse_i)

    if fault == "reversed":
        comm.Rotation = reversed_rotation
    elif fault == "dropped merge":
        R._merge = dropped_merge
    try:
        yield
    finally:
        comm.Rotation, R._merge = real_rotation, real_merge


def _cp_call(case, fn, q, k, v, n: int, fault=None):
    from tiny_flash_attention_tpu_torch.parallel import ring as R

    if case["mode"] != "zigzag":
        return fn(q, k, v)
    zq, zk, zv = (R.zigzag_permute(x, n) for x in (q, k, v))
    out = fn(zq, zk, zv)
    return out if fault == "no unpermute" else R.zigzag_unpermute(out, n)


def _cp_errs(out, refs) -> dict:
    """Out against the plain version and against B1 over the whole
    sequence (`refs`, _cp_refs): the dtype gate on out and the row gate
    against the plain version at the fold, and the same two gates against
    B1 (which folds q as fold_q does: one reference for both)."""
    from tiny_flash_attention_tpu_torch.utils.testing import (
        BF16_ROW_GATE, row_err, tolerance_for)

    plain, plain_fold, b1 = refs
    errs = {"out": max_err(out, plain), "row": row_err(out, plain_fold),
            "b1_out": max_err(out, b1), "b1_row": row_err(out, b1)}
    errs["ok"] = bool(torch.isfinite(out).all()) and all(
        errs[key] <= gate for key, gate in (
            ("out", tolerance_for(out.dtype)), ("row", BF16_ROW_GATE),
            ("b1_out", tolerance_for(out.dtype)), ("b1_row", BF16_ROW_GATE)))
    return errs


def _cp_refs(q, k, v, causal, segment_ids=None):
    """(plain, plain at the fold, B1) over the whole sequence in this one
    process, with `segment_ids` where given. The plain version runs one q
    head at a time against its kv head h // group: one head's f32 scores
    at 32768 are 4.3 GB, all 24 heads' would not fit on the card."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.utils.testing import fold_q

    sm_scale = q.shape[-1] ** -0.5
    fq, fscale = fold_q(q, sm_scale)
    group = q.shape[1] // k.shape[1]
    plain, plain_fold = torch.empty_like(q), torch.empty_like(q)
    for b in range(q.shape[0]):
        ids = None if segment_ids is None else tuple(
            x[b:b + 1] for x in segment_ids)
        for h in range(q.shape[1]):
            kv = (k[b:b + 1, h // group:h // group + 1],
                  v[b:b + 1, h // group:h // group + 1])
            plain[b, h] = flash_attention_plain(
                q[b:b + 1, h:h + 1], *kv, causal=causal,
                sm_scale=sm_scale, segment_ids=ids)[0, 0]
            plain_fold[b, h] = flash_attention_plain(
                fq[b:b + 1, h:h + 1], *kv, causal=causal,
                sm_scale=fscale, segment_ids=ids)[0, 0]
    torch.cuda.empty_cache()
    return plain, plain_fold, flash_attention(q, k, v, causal=causal,
                                              segment_ids=segment_ids)


def cp_rank(rank, device, cases):
    """One rank of a context-parallel world: each case's main-path call
    through the package entry (launches counted from 0, the flash launches
    timed by CUDA events, the call's wall), then, on rank 0, its output
    against the plain version and B1 over the whole sequence in this one
    process (_cp_refs, shared by the cases of one shape and mask), then the
    planted faults on every rank."""
    import torch.distributed as dist

    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.parallel import comm
    from tiny_flash_attention_tpu_torch.parallel.sharded import make_mesh

    n = dist.get_world_size()
    meshes, refs, results = {}, {}, []
    for case in cases:
        shape = case["mesh"] or (1, n)
        if shape not in meshes:
            meshes[shape] = make_mesh(n, *shape, device=device.type)
        mesh = meshes[shape]
        b, hq, hkv, seq, d = case["shape"]
        gen = torch.Generator(device=device).manual_seed(SEED)
        q = torch.randn((b, hq, seq, d), generator=gen, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, seq, d), generator=gen, device=device,
                            dtype=torch.float32).to(torch.bfloat16)
                for _ in range(2))
        fn = _cp_fn(case, mesh)
        flash_attention.launches = 0
        comm.host_staged_bytes = 0
        times = []
        torch.cuda.synchronize(device)
        dist.barrier()
        t0 = time.perf_counter()
        with _cp_timed_flash(times):
            out = _cp_call(case, fn, q, k, v, n)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        row = {"launches": flash_attention.launches,
               "staged": comm.host_staged_bytes,
               "flash_ms": sum(s.elapsed_time(e) for s, e in times),
               "wall_ms": wall_ms,
               "ctx_index": mesh.get_local_rank("model")}
        key = (case["shape"], case["causal"])
        if rank == 0:
            if key not in refs:
                refs[key] = _cp_refs(q, k, v, case["causal"])
            row.update(_cp_errs(out, refs[key]))
            row["bits"] = bool(torch.equal(out, refs[key][2]))
        row["faults"] = {}
        for fault in case["faults"]:
            with _cp_fault(fault):
                bad = _cp_call(case, fn, q, k, v, n, fault)
            if rank == 0:
                row["faults"][fault] = _cp_errs(bad, refs[key])
            del bad
        results.append(row)
        del q, k, v, out
    return results


CP_WORLDS = [
    # (ranks, backend, cases): the world of 1 on NCCL gives B1's bits in
    # every mode; the worlds of 2 and 4 share the card over gloo
    (1, "nccl", [cp_case("ring", True, CP_SHORT_SEQ),
                 cp_case("zigzag", True, CP_SHORT_SEQ),
                 cp_case("ulysses", True, CP_SHORT_SEQ),
                 cp_case("allgather", False, CP_SHORT_SEQ),
                 cp_case("sharded", True, CP_SHORT_SEQ,
                         batch=CP_SHARDED[0])]),
    (2, "gloo", [cp_case("ring", True, CP_SHORT_SEQ),
                 cp_case("ring", True, CP_SEQ),
                 cp_case("ring", False, CP_SEQ),
                 cp_case("zigzag", True, CP_SEQ),
                 cp_case("ulysses", True, CP_SEQ),
                 cp_case("allgather", False, CP_ALLGATHER_SEQ)]),
    (4, "gloo", [cp_case("ring", True, CP_SHORT_SEQ),
                 cp_case("zigzag", True, CP_SHORT_SEQ),
                 cp_case("ring", True, CP_SEQ,
                         faults=("reversed", "dropped merge")),
                 cp_case("ring", False, CP_SEQ),
                 cp_case("zigzag", True, CP_SEQ, faults=("no unpermute",)),
                 cp_case("ulysses", True, CP_SEQ),
                 cp_case("allgather", False, CP_ALLGATHER_SEQ),
                 cp_case("sharded", True, CP_SHARDED[1], batch=CP_SHARDED[0],
                         mesh=(2, 2))]),
]


def context_parallel_phase() -> dict:
    """Each world of CP_WORLDS through parallel/world.py::run_world: every
    mode's package entry at Llama-3.2-3B widths, each rank's launches
    asserted, rank 0's output held against the plain version and against
    B1 over the whole sequence (the dtype gate on out and the fold's row
    gate, utils/testing.py, against each; B1's bits in the world of 1); the
    planted faults must fail that gate. Then B1 over the whole sequence
    alone on the card, on the ported roofline. Returns the main-path
    launches of B1 summed over the ranks and the roofline."""
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.parallel.world import run_world
    from tiny_flash_attention_tpu_torch.utils.benchmarking import (
        cuda_time_ms)
    from tiny_flash_attention_tpu_torch.utils.profiling import roofline
    from tiny_flash_attention_tpu_torch.utils.testing import BF16_ROW_GATE

    torch.cuda.empty_cache()
    launches, failed = 0, []
    for n, backend, cases in CP_WORLDS:
        t0 = time.perf_counter()
        per_rank = run_world(cp_rank, n, backend=backend, device_type="cuda",
                             args=(cases,), timeout_s=CP_TIMEOUT_S)
        log(f"context parallel: world of {n} on {backend} (one card), "
            f"{time.perf_counter() - t0:.1f} s with its spawn")
        for i, case in enumerate(cases):
            rows = [ranks[i] for ranks in per_rank]
            head = rows[0]
            b, hq, hkv, seq, d = case["shape"]
            mesh = case["mesh"] or (1, n)
            want = [cp_expected_launches(case, r["ctx_index"],
                                         mesh[1]) for r in rows]
            got = [r["launches"] for r in rows]
            launches += sum(got)
            ok = head["ok"] and got == want and (
                backend != "nccl" or head["bits"]) and (
                backend == "gloo" or not any(r["staged"] for r in rows))
            log(f"  {case['mode']} causal={case['causal']} "
                f"({b},{hq},{seq},{d})/({b},{hkv}) mesh (data, model) "
                f"{mesh}: vs plain out err {head['out']:.3e} row "
                f"{head['row']:.3e}, vs B1 over the whole sequence out err "
                f"{head['b1_out']:.3e} row {head['b1_row']:.3e} (gates "
                f"2e-2; row {BF16_ROW_GATE:.4e})"
                + (f", B1's bits: {head['bits']}" if n == 1 else "")
                + f" | launches by rank {got} (expected {want}) | flash ms "
                f"by rank {[round(r['flash_ms'], 4) for r in rows]}, call "
                f"wall ms {[round(r['wall_ms'], 1) for r in rows]} | "
                f"{backend}, host_staged_bytes by rank "
                f"{[r['staged'] for r in rows]} | {'ok' if ok else 'FAIL'}")
            for fault, errs in head["faults"].items():
                caught = not errs["ok"]
                log(f"    planted fault '{fault}': vs plain out err "
                    f"{errs['out']:.3e} row {errs['row']:.3e}, vs B1 out err "
                    f"{errs['b1_out']:.3e} row {errs['b1_row']:.3e} | "
                    f"{'caught' if caught else 'NOT CAUGHT'}")
                ok = ok and caught
            if not ok:
                failed.append(f"{case['mode']} at n {n}")
    if failed:
        raise AssertionError(f"context parallel phase failed: {failed}")
    log(f"  B1 launches of the phase's main-path calls, every rank of every "
        f"world: {launches}")
    # B1 over the whole sequence alone on the card, on the ported roofline
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = randn((1, CP_HEADS[0], CP_SEQ, 128), torch.bfloat16, gen)
    k, v = (randn((1, CP_HEADS[1], CP_SEQ, 128), torch.bfloat16, gen)
            for _ in range(2))
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, causal=True),
                      iters=5)["median_ms"]
    flops = 4.0 * 128 * _visible_pairs(q, k, True)
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + q[..., 0].numel() * 4
    report = roofline(flops, nbytes, ms * 1e-3)
    log(f"  B1 over the whole sequence, (1,{CP_HEADS[0]},{CP_SEQ},128)/"
        f"(1,{CP_HEADS[1]}) causal, alone on the card: {ms:.4f} ms; "
        f"roofline (utils/profiling.py, H100 peaks): {report}")
    return {"launches": launches, "b1_ms": ms, "roofline": str(report)}


# --- sharded serving: tensor- and data-parallel engines ----------------------
# parallel/serve.py's ShardedInferenceEngine at Llama-3.2-3B's published
# widths (DIMS_MODELS[1]: d_model 3072, 24/8 heads of 128, d_ff 8192, vocab
# 128256, bf16), SERVE_LAYERS layers, random weights from SEED, which every
# rank builds itself before it cuts its shard. Traffic: the dims engines'
# 8 prompts (537-1819 tokens, two batched admissions of 4), SERVE_CHUNKS
# greedy steps(SERVE_CHUNK) over bf16 and int8 pages, then one sampled
# chunk. The card machine has one H100: the world of 1 runs on NCCL (tp 1:
# every all-reduce is the single-card residual add, so the engine's bits),
# the worlds of 2 and 4 share the card over gloo, so their times are of
# ranks time-sharing one card, not a tensor-parallel speed.
SERVE_LAYERS = 4
SERVE_CHUNK, SERVE_CHUNKS = 32, 2
SERVE_SAMPLED_STEPS, SERVE_TEMPERATURE = 16, 0.9
SERVE_SLOTS = 8
SERVE_TIMEOUT_S = 600.0
SERVE_FAULT_LAYER = 1
SERVE_RAGGED = ("packed page", "packed pow2", "jagged")
SERVE_OFFSETS_FAULT = "rank 0's pack offsets shifted by one page"
# (ranks, backend, runs): a run is (model, (data, model) mesh, data axis,
# page formats, planted faults, admission modes (ADMISSIONS' labels))
SERVE_WORLDS = [
    (1, "nccl", [("llama", (1, 1), None, ("bf16", "int8"), (),
                  ("batched",)),
                 ("llama", (1, 1), None, ("bf16",), (), SERVE_RAGGED)]),
    (2, "gloo", [("llama", (1, 2), None, ("bf16", "int8"),
                  ("w_down all-reduce skipped",), ("batched",)),
                 ("engine f32", (1, 2), None, ("bf16",), (), ("batched",)),
                 ("llama", (1, 2), None, ("bf16",), (SERVE_OFFSETS_FAULT,),
                  SERVE_RAGGED)]),
    (4, "gloo", [("llama", (2, 2), "data", ("bf16", "int8"),
                  ("group 1 at group 0's offset",), ("batched",)),
                 ("llama", (2, 2), "data", ("bf16",), (), SERVE_RAGGED),
                 ("llama", (1, 4), None, ("bf16", "int8"), (),
                  ("batched",))]),
]


def serve_model(model: str):
    """(cfg, the engine's logit gate) of a run's model."""
    from tiny_flash_attention_tpu_torch.models import transformer as T

    if model == "llama":
        return (T.ModelConfig(**DIMS_MODELS[1][1], n_layers=SERVE_LAYERS,
                              dtype=torch.bfloat16), ENGINE_LOGIT_GATE)
    return (dataclasses.replace(engine_config(), dtype=torch.float32),
            ENGINE_F32_LOGIT_GATE)


def serve_prompts(cfg) -> list:
    """The dims engines' 8 prompts (dims_engine_run): lengths 537-1819."""
    rng = np.random.default_rng(SEED)
    lens = sorted(int(n) for n in rng.integers(512, 2049, SERVE_SLOTS))
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def serve_geometry(fmt: str) -> dict:
    pps = -(-(2048 + SERVE_CHUNK * SERVE_CHUNKS + SERVE_SAMPLED_STEPS + 8)
            // 128)
    return dict(num_pages=SERVE_SLOTS * pps + 8, page_size=128,
                max_seqs=SERVE_SLOTS, pages_per_seq=pps, kv_format=fmt,
                seed=SEED, device="cuda")


def serve_counters(fmt: str, reset: bool = False) -> dict:
    """B1's, B11's, B4's (of the page format) and B5's launch counts."""
    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_page_append, fused_paged_decode_attention)

    b4 = "int8_launches" if fmt == "int8" else "launches"
    if reset:
        flash_attention.launches = 0
        flash_attention_rowloop.launches = 0
        setattr(fused_paged_decode_attention, b4, 0)
        fused_page_append.launches = 0
    return {"B1": flash_attention.launches,
            "B11": flash_attention_rowloop.launches,
            "B4": getattr(fused_paged_decode_attention, b4),
            "B5": fused_page_append.launches}


def serve_drive(eng, prompts, fmt, *, sampled: bool, barrier=None,
                mode: str = "batched") -> dict:
    """The main path of one engine: two admissions of 4 (by `mode`, a
    label of ADMISSIONS), then
    SERVE_CHUNKS greedy chunks (launches counted from 0 just before the
    admissions and read after the prefill and after the greedy chunks),
    then one sampled chunk at SERVE_TEMPERATURE. Returns the tokens, the
    state after the admissions, the launches and the walls."""
    from tiny_flash_attention_tpu_torch.models.engine import Request
    from tiny_flash_attention_tpu_torch.parallel import comm

    max_new = 1 + SERVE_CHUNK * SERVE_CHUNKS + SERVE_SAMPLED_STEPS + 8
    reqs = [Request(p, max_new) for p in prompts]
    serve_counters(fmt, reset=True)
    comm.host_staged_bytes = 0
    torch.cuda.synchronize()
    admit = {label: fn for label, fn, _ in ADMISSIONS}[mode]
    if barrier:
        barrier()
    t0 = time.perf_counter()
    for batch in (reqs[:4], reqs[4:]):
        admit(eng, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = serve_counters(fmt)
    snap = dict(pages=[p.clone() for p in eng.cache.pages],
                table=eng.cache.page_table.copy(),
                lengths=eng.cache.lengths.copy(),
                last=eng.last_token.copy())
    chunk_s = []
    for _ in range(SERVE_CHUNKS):
        t0 = time.perf_counter()
        eng.steps(SERVE_CHUNK)          # ends in a device-to-host copy
        chunk_s.append(time.perf_counter() - t0)
    launches = serve_counters(fmt)
    staged = comm.host_staged_bytes
    greedy = [list(r.generated) for r in reqs]
    last = len(eng.cache.pages) - 1
    out = {"prefill_launches": after_prefill, "launches": launches,
           "staged": staged, "prefill_ms": prefill_ms, "chunk_s": chunk_s,
           "greedy": greedy, "snap": snap,
           "table_after": eng.cache.page_table.copy(),
           "pages_greedy": {li: eng.cache.pages[li].clone()
                            for li in (0, last)}}
    if sampled:
        eng.temps[:] = SERVE_TEMPERATURE
        eng.steps(SERVE_SAMPLED_STEPS)
        out["sampled"] = [r.generated[len(g):] for r, g in zip(reqs, greedy)]
    return out


def serve_steps(lengths, table, device):
    """The greedy chunks' decode steps as the engine takes them from the
    state after the admissions: SERVE_CHUNKS chunks of SERVE_CHUNK steps,
    each chunk's table cut to the engine's width (its pages bucketed to a
    power of two). lengths: (slots,) host; table: the page table after the
    greedy chunks (global ids). Yields (step, positions, table) on
    `device`."""
    lengths = lengths.copy()
    table = torch.as_tensor(table, device=device)
    for chunk in range(SERVE_CHUNKS):
        need = int(lengths.max()) + SERVE_CHUNK
        bucket = 1 << max(0, (-(-need // 128) - 1)).bit_length()
        width = table[:, :bucket] if bucket < table.shape[1] else table
        for i in range(SERVE_CHUNK):
            yield (chunk * SERVE_CHUNK + i,
                   torch.as_tensor(lengths, device=device), width)
            lengths += 1


def serve_margins(cfg, params, prompts, run, fmt,
                  mode: str = "batched") -> tuple:
    """The single-card engine's logits at every greedy token: the
    prefills' (the first tokens, by the admission `mode`) and each decode
    step's, taken by decode_step from the state after the admissions
    (serve_steps). Asserts that their argmax is the engine's tokens.
    Returns (margins[slot][token], the top-2 margins as fractions of the
    largest |logit| of their step; the first tokens' logits (slots, V) and
    the decode steps' logits (steps, slots, V), f32 on the host; the pages
    after the steps)."""
    from tiny_flash_attention_tpu_torch.models.inference import decode_step

    def fractions(logits):
        top = logits.float().topk(2, dim=-1).values
        return ((top[:, 0] - top[:, 1]) / logits.abs().max()).tolist()

    margins = [[] for _ in prompts]
    argmax = [[] for _ in prompts]
    first_logits = []
    for first in (0, 4):
        logits = admission_logits(mode, cfg, params,
                                  prompts[first:first + 4], 128)
        for i, m in enumerate(fractions(logits)):
            margins[first + i].append(m)
            argmax[first + i].append(int(logits[i].argmax()))
        first_logits.append(logits.cpu())
        del logits
    snap = run["snap"]
    pages = [p.clone() for p in snap["pages"]]
    tokens = torch.as_tensor(snap["last"], device="cuda")
    steps = []
    for _, positions, table in serve_steps(snap["lengths"],
                                           run["table_after"], "cuda"):
        logits, _ = decode_step(cfg, params, pages, tokens, positions, table,
                                page_size=128, fmt=fmt)
        tokens = logits.argmax(-1).to(torch.int32)
        for i, m in enumerate(fractions(logits)):
            margins[i].append(m)
            argmax[i].append(int(tokens[i]))
        steps.append(logits.cpu())
    if argmax != run["greedy"]:
        raise AssertionError("the reference decode_step loop does not give "
                             "the single-card engine's tokens")
    return margins, torch.cat(first_logits), torch.stack(steps), pages


def serve_reference(model: str, fmt: str, ref_dir: str,
                    mode: str = "batched") -> dict:
    """The single-card engine's run (serve_drive, admitting by `mode`) in
    this process, and its margins, the first tokens' and every greedy
    decode step's logits (serve_margins), its pages after the admissions
    and after the greedy chunks (layers 0 and the last) and its tables,
    saved to ref_dir for the ranks."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.models.engine import InferenceEngine

    cfg, gate = serve_model(model)
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), device="cuda")
    prompts = serve_prompts(cfg)
    eng = InferenceEngine(cfg, params, **serve_geometry(fmt))
    run = serve_drive(eng, prompts, fmt,
                      sampled=model == "llama" and mode == "batched",
                      mode=mode)
    del eng
    snap = run["snap"]
    margins, first_logits, step_logits, loop_pages = serve_margins(
        cfg, params, prompts, run, fmt, mode)
    path = f"{ref_dir}/{model}_{fmt}_{mode}.pt".replace(" ", "_")
    last = cfg.n_layers - 1
    for li in (0, last):
        if not torch.equal(loop_pages[li], run["pages_greedy"][li]):
            raise AssertionError("the reference decode_step loop does not "
                                 "give the single-card engine's pages")
    del loop_pages
    torch.save({"step_logits": step_logits, "first_logits": first_logits,
                "table": torch.from_numpy(snap["table"]),
                "pages": {li: snap["pages"][li].cpu() for li in (0, last)},
                "table_greedy": torch.from_numpy(run["table_after"]),
                "lengths_greedy": torch.from_numpy(
                    snap["lengths"] + SERVE_CHUNK * SERVE_CHUNKS),
                "pages_greedy": {li: p.cpu() for li, p in
                                 run["pages_greedy"].items()}},
               path)
    torch.cuda.synchronize()
    step_ms = [t * 1e3 / SERVE_CHUNK for t in run["chunk_s"]]
    log(f"sharded serving reference [{model}, {fmt} pages, {mode} "
        f"admission]: the single-card "
        f"engine, prompts {[len(p) for p in prompts]}; launches "
        f"{run['launches']}; two admissions {run['prefill_ms']:.1f} ms; "
        f"decode ms/step by chunk {[round(x, 3) for x in step_ms]} -> "
        f"{SERVE_SLOTS * 1e3 / step_ms[-1]:.0f} tokens/s; smallest top-2 "
        f"margin {min(min(m) for m in margins):.2e} of max |logit| (gate "
        f"{gate:.1e})")
    return {"greedy": run["greedy"], "sampled": run.get("sampled"),
            "margins": margins, "path": path, "gate": gate,
            "step_ms": step_ms, "prefill_ms": run["prefill_ms"]}


def _serve_pages_err(got, want, fmt, n_tokens=None) -> float:
    """Max |got - want| over the K/V values of two page tensors (a slot's
    pages, in order), as a fraction of the largest |want| (int8 pages
    dequantized first); over the first n_tokens token rows, or every row
    of the pages."""
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        unpack_int8_pages)

    def values(p):
        if fmt != "int8":
            k, v = p[:, :, :128].float(), p[:, :, 128:].float()
        else:
            k, v, ks, vs = unpack_int8_pages(p, 128)
            k, v = k.float() * ks[..., None], v.float() * vs[..., None]
        return torch.stack([k.flatten(1, 2), v.flatten(1, 2)],
                           1)[:, :, :n_tokens]

    got, want = values(got), values(want)
    return float((got - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def _serve_fault(fault: str, n_layers: int):
    """A planted fault on every rank: "w_down all-reduce skipped" leaves
    layer SERVE_FAULT_LAYER's MLP output unsummed over the model axis (each
    rank adds its own partial); "group 1 at group 0's offset" localizes
    data group 1's page ids at group 0's base, clipped into its own block
    (nothing reads out of bounds); SERVE_OFFSETS_FAULT hands rank 0's
    packed prefill the pack offsets one page later (its segment ids stay
    right: only B1's pruned kv ranges, `segment_tiles`, go wrong)."""
    import torch.distributed as dist

    from tiny_flash_attention_tpu_torch.parallel import comm
    from tiny_flash_attention_tpu_torch.parallel import serve as S

    real_reduce, real_localize = comm.all_reduce, S.local_page_ids
    real_packed = S.prefill_forward_packed
    calls = []

    def skipping_reduce(x, group):
        calls.append(1)
        if (len(calls) - 1) % (2 * n_layers) == 2 * SERVE_FAULT_LAYER + 1:
            return x.clone()
        return real_reduce(x, group)

    def shifted_packed(*args, segment_starts, **kw):
        if dist.get_rank() == 0:
            segment_starts = tuple(o + 128 if o else 0
                                   for o in segment_starts)
        return real_packed(*args, segment_starts=segment_starts, **kw)

    if fault == "w_down all-reduce skipped":
        comm.all_reduce = skipping_reduce
    elif fault == SERVE_OFFSETS_FAULT:
        S.prefill_forward_packed = shifted_packed
    else:
        S.local_page_ids = lambda table, group, p_local: real_localize(
            table, 0, p_local)
    try:
        yield
    finally:
        comm.all_reduce, S.local_page_ids = real_reduce, real_localize
        S.prefill_forward_packed = real_packed


@contextlib.contextmanager
def _serve_kernel_checks(readings: dict):
    """While open, each call of B1 (with or without segment ids), B11, B4
    and B5 on the sharded engine's path (through the entries
    models/transformer.py and models/inference.py call) also runs its plain
    version on the same inputs: B1 against the plain version over its
    heads (_cp_refs, with the ids), out within the dtype gate of max(1, the
    largest |plain|) (the model's activations pass 1, where bf16's spacing
    alone exceeds an absolute 2e-2) and rows at the row gate at the fold;
    B11 (the jagged mode) the same against its plain version, on the rows
    below each length; B4 against its plain version at the kernel's splits
    and unsplit (split_errs: the decode gates), B5 bit for bit against its
    plain version on a copy of the pages. Appends each call's readings to
    readings["B1"], ["B11"], ["B4"], ["B5"]."""
    from tiny_flash_attention_tpu_torch.models import inference as I
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
        flash_attention_rowloop_plain)
    from tiny_flash_attention_tpu_torch.ops.paged_fused import (
        fused_paged_decode_plain, page_append_plain)
    from tiny_flash_attention_tpu_torch.utils.testing import (
        BF16_ROW_GATE, fold_q, row_err, tolerance_for)

    real_b1, real_b4, real_b5 = (T.flash_attention,
                                 I.fused_paged_decode_attention,
                                 I.fused_page_append)
    real_ids, real_b11 = I.flash_attention, I.flash_attention_rowloop

    def reading(key, out, plain, plain_fold, q, k, **extra):
        scale = max(1.0, float(plain.abs().max()))
        err, row = max_err(out, plain), row_err(out, plain_fold)
        readings[key].append({
            "out": err / scale, "abs": err, "scale": scale, "row": row,
            "ok": bool(torch.isfinite(out).all())
            and err / scale <= tolerance_for(out.dtype)
            and row <= BF16_ROW_GATE,
            "q": tuple(q.shape), "kv": tuple(k.shape), **extra})

    def b1(q, k, v, *, causal=False, window=None, **kw):
        if window is not None or kw:
            raise AssertionError("the serving phase's B1 check takes a "
                                 "causal or full mask only")
        out = real_b1(q, k, v, causal=causal)
        plain, plain_fold, _ = _cp_refs(q, k, v, causal)
        reading("B1", out, plain, plain_fold, q, k)
        return out

    def b1_ids(q, k, v, *, causal, segment_ids, segment_starts):
        out = real_ids(q, k, v, causal=causal, segment_ids=segment_ids,
                       segment_starts=segment_starts)
        plain, plain_fold, _ = _cp_refs(q, k, v, causal, segment_ids)
        reading("B1", out, plain, plain_fold, q, k, ids=True)
        return out

    def b11(q, k, v, *, causal, seq_lengths):
        out, lse = real_b11(q, k, v, causal=causal, seq_lengths=seq_lengths)
        sm_scale = q.shape[-1] ** -0.5
        plain, plain_fold = (flash_attention_rowloop_plain(
            qq, k, v, causal=causal, sm_scale=sc,
            seq_lengths=seq_lengths)[0]
            for qq, sc in ((q, sm_scale), fold_q(q, sm_scale)))
        reading("B11", out, plain, plain_fold, q, k,
                lens=tuple(seq_lengths.tolist()))
        return out, lse

    def b4(q, pages, lengths, table, *, page_size, window=None):
        out, lse = real_b4(q, pages, lengths, table, page_size=page_size,
                           window=window)
        err, row, lse_err, ok = split_errs(
            out, lse, lambda sp: fused_paged_decode_plain(
                q, pages, lengths, table, page_size=page_size,
                sm_scale=q.shape[-1] ** -0.5, window=window, splits=sp))
        readings["B4"].append({"out": err, "row": row, "lse": lse_err,
                               "ok": ok, "q": tuple(q.shape),
                               "pages": tuple(pages.shape),
                               "table": tuple(table.shape)})
        return out, lse

    def b5(pages, k_new, v_new, page_ids, rows, *, page_size):
        want = page_append_plain(pages.clone(), k_new, v_new, page_ids, rows,
                                 page_size=page_size)
        got = real_b5(pages, k_new, v_new, page_ids, rows,
                      page_size=page_size)
        readings["B5"].append({"ok": bool(torch.equal(
            got.view(torch.uint8), want.view(torch.uint8))),
            "new": tuple(k_new.shape)})
        return got

    T.flash_attention = b1
    I.flash_attention, I.flash_attention_rowloop = b1_ids, b11
    I.fused_paged_decode_attention, I.fused_page_append = b4, b5
    try:
        yield
    finally:
        T.flash_attention = real_b1
        I.flash_attention, I.flash_attention_rowloop = real_ids, real_b11
        I.fused_paged_decode_attention = real_b4
        I.fused_page_append = real_b5


def serve_rank(rank, device, runs, refs):
    """One rank of a sharded-serving world: every run of its world, each
    page format and admission mode through serve_drive on the
    ShardedInferenceEngine, the two admissions' prefills again (the first
    tokens' logits against the single-card engine's), then,
    off the main path and from the state after the admissions, the greedy
    chunks' steps again through sharded_decode_step fed the single-card
    engine's tokens (so that a token flipped at a near tie does not change
    a step's input): each step's logits against the single-card engine's
    (refs), the local pages after the admissions and after those steps
    against its slice, and the planted faults on the first step (the pack
    offsets' on the first admission's prefill). B1 or B11 (both
    admissions' prefills again), B4 and B5 (the first and the last forced
    step) are held against their plain versions on this rank's inputs
    (_serve_kernel_checks)."""
    import torch.distributed as dist

    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.parallel.serve import (
        ShardedInferenceEngine, sharded_decode_step)
    from tiny_flash_attention_tpu_torch.parallel.sharded import make_mesh

    card_settings()     # each rank is a process of its own
    n = dist.get_world_size()
    last_step = SERVE_CHUNK * SERVE_CHUNKS - 1
    results, meshes = [], {}
    for model, shape, data_axis, fmts, faults, modes in runs:
        cfg, gate = serve_model(model)
        params = T.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(SEED), device=device)
        prompts = serve_prompts(cfg)
        if shape not in meshes:
            meshes[shape] = make_mesh(n, *shape, device="cuda")
        mesh = meshes[shape]
        dp, tp = shape
        g, m = divmod(rank, tp)
        for fmt, mode in [(f, a) for f in fmts for a in modes]:
            ref = refs[(model, fmt, mode)]
            eng = ShardedInferenceEngine(cfg, params, mesh,
                                         data_axis=data_axis,
                                         **serve_geometry(fmt))
            run = serve_drive(eng, prompts, fmt,
                              sampled=model == "llama" and mode == "batched",
                              barrier=dist.barrier, mode=mode)
            snap = run.pop("snap")
            table_after = run.pop("table_after")
            del run["pages_greedy"]
            saved = torch.load(ref["path"], mmap=True, weights_only=True)
            rows = slice(g * SERVE_SLOTS // dp, (g + 1) * SERVE_SLOTS // dp)
            forced = torch.tensor(ref["greedy"], dtype=torch.int32)

            def step(pages, j, positions, table):
                return sharded_decode_step(
                    cfg, mesh, eng.params, pages, forced[:, j].to(device),
                    positions, table, page_size=128, fmt=fmt,
                    data_axis=data_axis)

            def logit_err(logits, j):
                want = saved["step_logits"][j][rows].to(device)
                return (float((logits - want).abs().max()
                              / want.abs().max()),
                        bool(torch.equal(logits, want)))

            def first_logits(batches=(0, 4)):
                """The admissions' prefills again on this engine: the
                first tokens' logits (4 per admission), on the host."""
                return torch.cat([admission_logits(
                    mode, cfg, eng.params, prompts[i:i + 4], 128,
                    eng=eng).cpu() for i in batches])

            def rel_err(got, want):
                return float((got - want).abs().max() / want.abs().max())

            checks = {"B1": [], "B11": [], "B4": [], "B5": []}
            with _serve_kernel_checks(checks):
                first = first_logits()
            run.update(first_err=rel_err(first, saved["first_logits"]),
                       first_bits=bool(torch.equal(first,
                                                   saved["first_logits"])))
            pages = [p.clone() for p in snap["pages"]]
            errs, bits, finite = [], True, True
            for j, positions, table in serve_steps(snap["lengths"],
                                                   table_after, device):
                with (_serve_kernel_checks(checks) if j in (0, last_step)
                      else contextlib.nullcontext()):
                    logits = step(pages, j, positions, table)
                err, same = logit_err(logits, j)
                errs.append(err)
                bits = bits and same
                finite = finite and bool(torch.isfinite(logits).all())
            run.update(logit_errs=errs, logit_bits=bits, finite=finite,
                       kernel_checks=checks)
            # each of this data group's slots: its pages here (global ids
            # mapped by the cache) against the same slot's pages of the
            # single-card engine (its own ids), this rank's kv heads; after
            # the admissions every row of the slot's pages, after the
            # forced steps its tokens
            hkv = cfg.n_kv_heads // tp
            for key, mine_pages, mine_table, tab, pag, n_tok in (
                    ("page_err", snap["pages"], snap["table"], "table",
                     "pages", None),
                    ("page_err_greedy", pages, table_after, "table_greedy",
                     "pages_greedy", saved["lengths_greedy"])):
                run[key] = 0.0
                for li, ref_pages in saved[pag].items():
                    for slot in range(rows.start, rows.stop):
                        length = (int(snap["lengths"][slot]) if n_tok is None
                                  else int(n_tok[slot]))
                        held = -(-length // 128)
                        mine = eng.cache.local_ids(
                            mine_table[slot, :held]).long()
                        theirs = saved[tab][slot, :held].long()
                        run[key] = max(run[key], _serve_pages_err(
                            mine_pages[li][:, mine],
                            ref_pages[m * hkv:(m + 1) * hkv][:, theirs]
                            .to(device), fmt,
                            None if n_tok is None else length))
            run["faults"] = {}
            _, positions, table = next(serve_steps(snap["lengths"],
                                                   table_after, device))
            for fault in faults:
                if fault == SERVE_OFFSETS_FAULT:
                    if mode != "packed page":
                        continue
                    with _serve_fault(fault, cfg.n_layers):
                        run["faults"][fault] = rel_err(
                            first_logits((0,)), saved["first_logits"][:4])
                    continue
                with _serve_fault(fault, cfg.n_layers):
                    run["faults"][fault] = logit_err(step(
                        [p.clone() for p in snap["pages"]], 0, positions,
                        table), 0)[0]
            run.update(model=model, mesh=shape, fmt=fmt, gate=gate,
                       mode=mode,
                       local_pages=tuple(snap["pages"][0].shape),
                       n_groups=eng.cache.n_groups)
            results.append(run)
            del eng, snap, saved, pages, logits
            torch.cuda.empty_cache()
        del params
    return results


def _serve_token_check(got, ref) -> tuple[bool, int, int]:
    """The near-tie rule: each slot's greedy tokens equal the single-card
    engine's up to its first token whose single-card top-2 margin is
    below the gate (that token and the rest are not compared). Returns
    (ok, tokens compared, slots cut at a near tie)."""
    ok, compared, cut = True, 0, 0
    for got_s, want_s, margins in zip(got, ref["greedy"], ref["margins"]):
        for i, (a, b) in enumerate(zip(got_s, want_s)):
            if margins[i] < ref["gate"]:
                cut += 1
                break
            compared += 1
            ok = ok and a == b
    return ok, compared, cut


def _serve_kernel_readings(rows, n_layers, dtype,
                           mode: str = "batched") -> tuple[str, bool]:
    """(what the ranks' _serve_kernel_checks read, every rank's B1 (with
    segment ids after a packed admission) or B11 (jagged), B4 and B5
    checked 2 n_layers times and passing)."""
    from tiny_flash_attention_tpu_torch.utils.testing import (
        BF16_ROW_GATE, tolerance_for)

    prefill = "B11" if mode == "jagged" else "B1"
    want = {"B1": 0, "B11": 0, prefill: 2 * n_layers, "B4": 2 * n_layers,
            "B5": 2 * n_layers}
    ok = all(len(r["kernel_checks"][key]) == n and all(
        c["ok"] for c in r["kernel_checks"][key])
        for r in rows for key, n in want.items())

    def worst(key, field):
        return max(c[field] for r in rows for c in r["kernel_checks"][key])

    def shapes(key, *fields):
        return sorted({tuple(c[f] for f in fields)
                       for r in rows for c in r["kernel_checks"][key]})

    name = {"batched": "B1", "jagged": "B11 (jagged)"}.get(
        mode, "B1 with segment ids")
    text = (f"{name} q/kv {shapes(prefill, 'q', 'kv')}: out "
            f"{worst(prefill, 'out'):.3e}"
            f" of max(1, max |plain|) (gate {tolerance_for(dtype):.0e}; "
            f"absolute {worst(prefill, 'abs'):.3e}, max |plain| up to "
            f"{worst(prefill, 'scale'):.3f}), row "
            f"{worst(prefill, 'row'):.3e} (gate "
            f"{BF16_ROW_GATE:.4e}); B4 q/pages/table "
            f"{shapes('B4', 'q', 'pages', 'table')}: out "
            f"{worst('B4', 'out'):.3e} (gate {DECODE_OUT_GATE:.0e}), row "
            f"{worst('B4', 'row'):.3e} (gate {DECODE_ROW_GATE:.4e}), lse "
            f"{worst('B4', 'lse'):.3e} (gate {DECODE_LSE_GATE:.0e}); B5 new "
            f"rows {shapes('B5', 'new')}: bit for bit "
            f"{all(c['ok'] for r in rows for c in r['kernel_checks']['B5'])}"
            f" | {'ok' if ok else 'FAIL'}")
    return text, ok


def sharded_serving_phase() -> dict:
    """Each world of SERVE_WORLDS through parallel/world.py::run_world,
    every rank running ShardedInferenceEngine's main path (serve_rank)
    against the single-card engine run first in this process
    (serve_reference). Gates: every rank's tokens the same; the world of 1
    the single-card engine's tokens (greedy and sampled) and every forced
    step's logits bit for bit; the TP worlds' logits at every forced step
    within the engine's gate of the largest |logit| and their greedy
    tokens equal up to the first near tie (_serve_token_check); the local
    pages after the admissions and after the forced steps within the
    dtype gate of the single-card engine's slice (int8 pages
    dequantized); B1, B4 and B5 on each rank's inputs against their plain
    versions (_serve_kernel_checks), 2 n_layers calls each; each rank's
    B1, B4 and B5 launches n_layers a prefill and a step; gloo staging
    positive, NCCL's 0; each planted fault fails the logit gate. Returns
    the main-path launches summed over every rank of every world, by
    kernel row."""
    import tempfile

    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.parallel.world import run_world
    from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

    _build.build()      # a no-op after main()'s build; the runs are timed
    torch.cuda.empty_cache()
    totals = {"flash_fwd": 0, "flash_fwd_f32": 0, "flash_rowloop": 0,
              "paged_decode": 0, "paged_decode_int8": 0, "page_append": 0}
    failed = []
    with tempfile.TemporaryDirectory() as ref_dir:
        refs = {}
        for _, _, runs in SERVE_WORLDS:
            for model, _, _, fmts, _, modes in runs:
                for key in [(model, f, a) for f in fmts for a in modes]:
                    if key not in refs:
                        refs[key] = serve_reference(*key[:2], ref_dir,
                                                    key[2])
                        torch.cuda.empty_cache()
        for n, backend, runs in SERVE_WORLDS:
            t0 = time.perf_counter()
            per_rank = run_world(serve_rank, n, backend=backend,
                                 device_type="cuda", args=(runs, refs),
                                 timeout_s=SERVE_TIMEOUT_S)
            log(f"sharded serving: world of {n} on {backend} (one card), "
                f"{time.perf_counter() - t0:.1f} s with its spawn")
            for i in range(len(per_rank[0])):
                rows = [ranks[i] for ranks in per_rank]
                head = rows[0]
                model, fmt, mesh = head["model"], head["fmt"], head["mesh"]
                mode = head["mode"]
                ref = refs[(model, fmt, mode)]
                cfg = serve_model(model)[0]
                L = cfg.n_layers
                steps = SERVE_CHUNK * SERVE_CHUNKS
                jagged = mode == "jagged"
                want = {"B1": 0 if jagged else 2 * L,
                        "B11": 2 * L if jagged else 0, "B4": steps * L,
                        "B5": steps * L}
                got = [r["launches"] for r in rows]
                same = all(r["greedy"] == head["greedy"]
                           and r.get("sampled") == head.get("sampled")
                           for r in rows)
                first_err = max(r["logit_errs"][0] for r in rows)
                prefill_err = max(r["first_err"] for r in rows)
                logit_err = max(max(r["logit_errs"]) for r in rows)
                page_err = max(r["page_err"] for r in rows)
                greedy_page_err = max(r["page_err_greedy"] for r in rows)
                tok_ok, compared, cut = _serve_token_check(head["greedy"],
                                                           ref)
                if n == 1:
                    exact = head["greedy"] == ref["greedy"] and (
                        head.get("sampled") == ref["sampled"]) and all(
                        r["logit_bits"] and r["first_bits"] for r in rows)
                else:
                    exact = tok_ok and max(logit_err,
                                           prefill_err) <= head["gate"]
                staged = [r["staged"] for r in rows]
                kchecks, kernels_ok = _serve_kernel_readings(rows, L,
                                                             cfg.dtype, mode)
                ok = (same and exact and kernels_ok
                      and all(r["finite"] for r in rows)
                      and all(x == want for x in got)
                      and max(page_err, greedy_page_err)
                      <= tolerance_for(cfg.dtype)
                      and (all(s > 0 for s in staged) if backend == "gloo"
                           else not any(staged)))
                for key, kernel in (("B1", "flash_fwd"),
                                    ("B11", "flash_rowloop"),
                                    ("B4", "paged_decode"),
                                    ("B5", "page_append")):
                    if key == "B1" and cfg.dtype == torch.float32:
                        kernel = "flash_fwd_f32"
                    if key == "B4" and fmt == "int8":
                        kernel = "paged_decode_int8"
                    if key == "B4" and cfg.dtype == torch.float32:
                        continue        # f32 q at 128: no row of its own
                    totals[kernel] += sum(x[key] for x in got)
                step_ms = [[round(t * 1e3 / SERVE_CHUNK, 3)
                            for t in r["chunk_s"]] for r in rows]
                tok_s = [round(SERVE_SLOTS * SERVE_CHUNK / r["chunk_s"][-1])
                         for r in rows]
                log(f"  [{model}, {fmt} pages, {mode} admission] mesh "
                    f"(data, model) {mesh}"
                    f"{', data_axis' if head['n_groups'] > 1 else ''}: local "
                    f"pages {head['local_pages']}, n_groups "
                    f"{head['n_groups']}; ranks' tokens the same: {same}; "
                    + (f"the single-card engine's tokens, the first tokens' "
                       f"logits and the logits of "
                       f"all {steps} forced steps bit for bit: {exact}"
                       if n == 1 else
                       f"the first tokens' logits (the admissions' "
                       f"prefills) {prefill_err:.3e} of max |logit|; "
                       f"logits vs the single-card engine, fed its tokens, "
                       f"first step {first_err:.3e}, worst of {steps} steps "
                       f"{logit_err:.3e} of max |logit| (gate "
                       f"{head['gate']:.1e}); greedy tokens equal the "
                       f"single-card engine's on {compared} compared "
                       f"({cut} slots cut at a near tie): {tok_ok}")
                    + f"; local pages vs the single-card slice after the "
                    f"admissions {page_err:.3e}, after the forced steps "
                    f"{greedy_page_err:.3e} of max |value| (gate "
                    f"{tolerance_for(cfg.dtype):.0e}) | launches by rank "
                    f"{got} (expected {want} each) | {backend}, "
                    f"host_staged_bytes by rank {staged} | "
                    f"{'ok' if ok else 'FAIL'}")
                log(f"    kernels against their plain versions on the "
                    f"ranks' inputs: {kchecks}")
                log(f"    ranks time-sharing one card: two admissions ms by "
                    f"rank {[round(r['prefill_ms'], 1) for r in rows]} (the "
                    f"single-card engine {ref['prefill_ms']:.1f}); "
                    f"decode wall ms a step by rank and chunk {step_ms} -> "
                    f"tokens/s by rank {tok_s} (last chunk, {SERVE_SLOTS} "
                    f"slots); the single-card engine "
                    f"{[round(x, 3) for x in ref['step_ms']]} ms a step")
                if head.get("sampled") is not None and n > 1:
                    agree = sum(a == b for s, w in zip(head["sampled"],
                                                      ref["sampled"])
                                for a, b in zip(s, w))
                    log(f"    sampled chunk (temperature "
                        f"{SERVE_TEMPERATURE}): {agree} of "
                        f"{SERVE_SLOTS * SERVE_SAMPLED_STEPS} tokens as the "
                        f"single-card engine's (not gated at tp > 1)")
                for fault in head["faults"]:
                    err = max(r["faults"][fault] for r in rows)
                    caught = err > head["gate"]
                    what = ("the first admission's first tokens'"
                            if fault == SERVE_OFFSETS_FAULT else
                            "first-step")
                    log(f"    planted fault '{fault}': {what} logits "
                        f"{err:.3e} of max |logit| | "
                        f"{'caught' if caught else 'NOT CAUGHT'}")
                    ok = ok and caught
                if not ok:
                    failed.append(f"{model} {fmt} mesh {mesh}")
    if failed:
        raise AssertionError(f"sharded serving phase failed: {failed}")
    log(f"  sharded serving main-path launches, every rank of every world: "
        f"{totals}")
    return {"launches": totals}


# --- phase: the sharded train step -------------------------------------------

# parallel/train.py's make_train_step on (data, model) DeviceMeshes of ranks
# on this card (the phase `sharded_train_phase`), against the single-card
# step run first in the parent process: the train cell's model (engine
# benchmark widths, 4 layers, bf16) at 4 x 2048 in a world of 1 on NCCL
# (every axis of size 1 makes no collective: the single-card step's bits)
# and on (2, 1), (1, 2) and (2, 2) over gloo; the windowed model (swa train
# cell) at 1 x 8192, the model in f32 at 1 x 1024 and Llama-3.2-3B's widths
# (24/8 heads, 12/4 a rank, group 3) at 1 x 2048 on (1, 2); then two
# processes configured by the environment (initialize_multihost, gloo asked
# for) on make_hybrid_mesh(num_slices=2). Nothing is cut but the 4 layers.
# The worlds of 2 and 4 share the card over gloo: their times are of ranks
# time-sharing one card through host copies, not a parallel speed.
TS_SGD_LR = 1e-3
TS_ADAMW_STEPS = 3
TS_ENV_STEPS = 2
# the first step's loss against the single card's, relative
TS_LOSS_GATE = 1e-3
# a planted fault's gradient distance must exceed the gate this many times
TS_FAULT_MARGIN = 5.0
TS_TIMEOUT_S = 600.0
TS_SHAPES = {"train": (4, 2048), "swa": (1, 8192), "f32": (1, 1024),
             "llama": (1, 2048)}
# (ranks, backend, runs): a run is (model, (data, model) mesh, planted
# faults)
TS_WORLDS = [
    (1, "nccl", [("train", (1, 1), ())]),
    (2, "gloo", [("train", (2, 1), ("data mean taken as a sum",)),
                 ("train", (1, 2), ("f's backward all-reduce dropped",)),
                 ("swa", (1, 2), ()), ("f32", (1, 2), ()),
                 ("llama", (1, 2), ())]),
    (4, "gloo", [("train", (2, 2), ())]),
]


def card_settings() -> None:
    """The JAX reference's arithmetic on the card: f32 products in full f32
    (no TF32), bf16 products accumulated in f32 and rounded once. A rank
    is a process of its own and sets them itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def ts_inputs(model: str, device):
    """(cfg, params, tokens) of a model: random weights and one token
    batch from SEED, the same bits in every process on the card."""
    from tiny_flash_attention_tpu_torch.models import transformer as T

    cfg = engine_config()
    if model == "llama":
        cfg = T.ModelConfig(**DIMS_MODELS[1][1], n_layers=cfg.n_layers,
                            dtype=torch.bfloat16)
    elif model == "swa":
        cfg = dataclasses.replace(cfg, attn_window=SWA_WINDOW)
    elif model == "f32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = T.init_params(cfg, gen, device=device)
    tokens = torch.randint(0, cfg.vocab_size, TS_SHAPES[model],
                           generator=gen, device=device)
    return cfg, params, tokens


def ts_sgd(cfg, params, tokens, mesh=None, device=None, steps=1):
    """SGD(TS_SGD_LR) steps from `params`: (losses, the first step's
    gradients, by param_leaves, after the data mean on a mesh, the
    launches of each kernel entry)."""
    from tiny_flash_attention_tpu_torch.parallel.train import (
        make_train_step, param_leaves)

    step, init = make_train_step(
        cfg, mesh, optimizer=lambda ps: torch.optim.SGD(ps, lr=TS_SGD_LR),
        device=device)
    p, opt = init(params)
    losses, grads = [], None
    for _ in range(steps):
        p, opt, loss = step(p, opt, tokens)
        losses.append(loss)
        if grads is None:
            grads = [t.grad.clone() for t in param_leaves(p)]
    return losses, grads


def ts_reference(model: str, ref_dir: str) -> dict:
    """The single-card step on the model's inputs: two SGD steps (their
    losses, the first one's gradients), then TS_ADAMW_STEPS AdamW steps
    (their losses and, for the train cell, the leaves after them), saved
    to ref_dir for the ranks."""
    from tiny_flash_attention_tpu_torch.parallel.train import (
        make_train_step, param_leaves)

    cfg, params0, tokens = ts_inputs(model, "cuda")
    sgd, grads = ts_sgd(cfg, params0, tokens, steps=TS_ENV_STEPS)
    step, init = make_train_step(cfg, learning_rate=1e-3)
    p, opt = init(params0)
    adamw, walls = [], []
    for _ in range(TS_ADAMW_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt, loss = step(p, opt, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        adamw.append(loss.cpu())
    path = f"{ref_dir}/{model}.pt"
    torch.save({"grads": [g.cpu() for g in grads],
                "adamw": adamw,
                "leaves": ([t.detach().cpu() for t in param_leaves(p)]
                           if model == "train" else None)}, path)
    sgd = [float(x) for x in sgd]
    log(f"sharded train reference [{model}]: the single-card step, "
        f"{cfg.n_q_heads}/{cfg.n_kv_heads} heads, "
        f"{str(cfg.dtype).split('.')[-1]}, tokens {tuple(tokens.shape)}"
        f"{f', window {cfg.attn_window}' if cfg.attn_window else ''}; SGD "
        f"losses {sgd}; AdamW losses {[float(x) for x in adamw]}; AdamW "
        f"wall ms a step {[round(w * 1e3, 2) for w in walls]}")
    return {"path": path, "sgd": sgd, "adamw": [float(x) for x in adamw],
            "ms": [w * 1e3 for w in walls]}


def ts_grad_err(grads, ref_grads, cfg, tp: int, m: int) -> float:
    """The largest relative Frobenius distance of a rank's gradients from
    their blocks of the single card's (param_specs' cut)."""
    from tiny_flash_attention_tpu_torch.parallel.train import (
        _block, _leaf_dims)

    worst = 0.0
    for g, w, dim in zip(grads, ref_grads, _leaf_dims(cfg.n_layers)):
        w = _block(w, dim, tp, m).to(g.device).float()
        worst = max(worst, float((g.float() - w).norm() / w.norm()))
    return worst


@contextlib.contextmanager
def ts_capture(captured: list):
    """While open, the island's first flash call keeps its q, k, v and
    mask, and its output's gradient (dO) once backward() reaches it."""
    from tiny_flash_attention_tpu_torch.parallel import train as TR

    real = TR.flash_attention

    def first(q, k, v, *, causal, window=None):
        out = real(q, k, v, causal=causal, window=window)
        if not captured:
            captured.append({"q": q.detach(), "k": k.detach(),
                             "v": v.detach(), "causal": causal,
                             "window": window})
            out.register_hook(lambda g: captured[0].update(do=g.detach()))
        return out

    TR.flash_attention = first
    try:
        yield
    finally:
        TR.flash_attention = real


def ts_kernel_checks(c: dict) -> dict:
    """B1 and the backward on a rank's own q/k/v/dO of one layer against
    their plain versions. B1: out within the dtype gate of max(1, max
    |plain|) (the model's activations pass 1, where one bf16 ulp exceeds
    an absolute 2e-2; the sharded-serving check's gate), the LSE within
    the dtype gate, and in bf16, against the plain version at the fold,
    the rows at the row gate and the LSE at BF16_LSE_GATE. The backward:
    dq/dk/dv within BWD_PLAIN_GATE of their largest |plain|."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_plain)
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from tiny_flash_attention_tpu_torch.utils.testing import (
        BF16_LSE_GATE, BF16_ROW_GATE, fold_q, row_err, tolerance_for)

    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    mask = dict(causal=c["causal"], window=c["window"])
    sm_scale = q.shape[-1] ** -0.5
    out, lse = flash_attention(q, k, v, return_lse=True, **mask)
    plain, plain_lse = flash_attention_plain(q, k, v, sm_scale=sm_scale,
                                             return_lse=True, **mask)
    tol = tolerance_for(q.dtype)
    scale = max(1.0, float(plain.abs().max()))
    fwd = {"out": max_err(out, plain) / scale, "scale": scale,
           "lse": max_err(lse, plain_lse)}
    ok = fwd["out"] <= tol and fwd["lse"] <= tol
    if q.dtype == torch.bfloat16:
        fq, fold_scale = fold_q(q, sm_scale)
        fold_out, fold_lse = flash_attention_plain(
            fq, k, v, sm_scale=fold_scale, return_lse=True, **mask)
        fwd.update(row=row_err(out, fold_out),
                   fold_lse=max_err(lse, fold_lse))
        ok = ok and fwd["row"] <= BF16_ROW_GATE \
            and fwd["fold_lse"] <= BF16_LSE_GATE
        del fold_out, fold_lse
    del plain, plain_lse
    got = flash_attention_bwd(q, k, v, out, lse, do, **mask)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                      sm_scale=sm_scale, **mask)
    bwd = [_rel_err(g, p) for g, p in zip(got, plain)]
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *got))
    return {"fwd": fwd, "bwd": bwd, "q": tuple(q.shape),
            "kv": tuple(k.shape), "bwd_gate": BWD_PLAIN_GATE[q.dtype],
            "ok": ok and finite and max(bwd) <= BWD_PLAIN_GATE[q.dtype]}


@contextlib.contextmanager
def ts_fault(fault: str):
    """A planted fault on every rank, while the step is made and run:
    "f's backward all-reduce dropped" makes comm.enter_model the bare
    identity (each rank keeps its partial gradient of the normed inputs);
    "data mean taken as a sum" leaves the data axis's sums undivided."""
    import torch.distributed as dist

    from tiny_flash_attention_tpu_torch.parallel import comm
    from tiny_flash_attention_tpu_torch.parallel import train as TR

    real_enter, real_mean = comm.enter_model, TR._data_mean

    def summed(leaves, loss, group):
        mean = real_mean(leaves, loss, group)
        for p in leaves:
            p.grad.mul_(dist.get_world_size(group))
        return mean

    if fault == "f's backward all-reduce dropped":
        comm.enter_model = lambda x, group: x
    else:
        TR._data_mean = summed
    try:
        yield
    finally:
        comm.enter_model, TR._data_mean = real_enter, real_mean


def ts_rank(rank, device, runs, refs):
    """One rank of a sharded-train world, every run of its world: one SGD
    step (this rank's gradients after the data mean against its blocks of
    the single card's; layer 0's attention inputs and dO kept for the
    kernel checks), then the main path, TS_ADAMW_STEPS AdamW steps with
    the launch counts and the staged bytes zeroed just before and read just
    after, then each planted fault's SGD step."""
    import torch.distributed as dist

    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd)
    from tiny_flash_attention_tpu_torch.parallel import comm
    from tiny_flash_attention_tpu_torch.parallel.sharded import make_mesh
    from tiny_flash_attention_tpu_torch.parallel.train import (
        _leaf_dims, make_train_step, param_leaves)

    card_settings()
    n = dist.get_world_size()
    results, meshes = [], {}
    for model, shape, faults in runs:
        if shape not in meshes:
            meshes[shape] = make_mesh(n, *shape, device=device.type)
        mesh = meshes[shape]
        m = mesh.get_local_rank("model")
        cfg, params0, tokens = ts_inputs(model, device)
        ref = torch.load(refs[model]["path"], mmap=True, weights_only=True)
        captured = []
        with ts_capture(captured):
            sgd, grads = ts_sgd(cfg, params0, tokens, mesh, device)
        run = {"model": model, "mesh": shape, "sgd_loss": float(sgd[0]),
               "grad_err": ts_grad_err(grads, ref["grads"], cfg, shape[1],
                                       m),
               "grad_bits": shape == (1, 1) and all(
                   torch.equal(g.cpu(), w)
                   for g, w in zip(grads, ref["grads"])),
               "kernels": ts_kernel_checks(captured[0])}
        del grads, captured

        step, init = make_train_step(cfg, mesh, learning_rate=1e-3,
                                     device=device)
        p, opt = init(params0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        dist.barrier()
        # ---- the main path: counts zeroed just before, read just after ----
        flash_attention.launches = 0
        flash_attention_bwd.launches = 0
        comm.host_staged_bytes = 0
        losses, walls = [], []
        for _ in range(TS_ADAMW_STEPS):
            t0 = time.perf_counter()
            p, opt, loss = step(p, opt, tokens)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(loss.cpu())
        run["launches"] = {"fwd": flash_attention.launches,
                           "bwd": flash_attention_bwd.launches}
        run["staged"] = comm.host_staged_bytes
        # ---------------------------------------------------------------------
        run["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        run["walls"] = walls
        run["adamw"] = losses
        leaves = param_leaves(p)
        if ref["leaves"] is not None and shape == (1, 1):
            run["leaf_bits"] = all(torch.equal(t.detach().cpu(), w)
                                   for t, w in zip(leaves, ref["leaves"]))
        # the replicated leaves must stay the same on every rank
        run["replicated"] = [float(t.detach().double().sum())
                             for t, dim in zip(leaves,
                                               _leaf_dims(cfg.n_layers))
                             if dim is None]
        del p, opt, leaves, step
        run["faults"] = {}
        for fault in faults:
            with ts_fault(fault):
                _, grads = ts_sgd(cfg, params0, tokens, mesh, device)
            run["faults"][fault] = ts_grad_err(grads, ref["grads"], cfg,
                                               shape[1], m)
            del grads
        results.append(run)
        del params0, ref
        torch.cuda.empty_cache()
    return results


def ts_env_rank(out_path: str) -> None:
    """One process of the environment-configured world (`python3
    chip_smoke.py --train-sharded-env OUT` with MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK set): initialize_multihost with gloo asked for,
    make_hybrid_mesh(num_slices=2) ('data' across the two "hosts"), then
    TS_ENV_STEPS SGD steps of the train cell's model; writes the losses,
    the mesh and the launches to OUT as JSON."""
    import torch.distributed as dist

    from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        flash_attention_bwd)
    from tiny_flash_attention_tpu_torch.parallel import comm
    from tiny_flash_attention_tpu_torch.parallel.multihost import (
        initialize_multihost, make_hybrid_mesh)

    card_settings()
    initialize_multihost(backend="gloo", timeout_s=TS_TIMEOUT_S)
    try:
        mesh = make_hybrid_mesh(num_slices=2)
        cfg, params0, tokens = ts_inputs("train", "cuda")
        flash_attention.launches = 0
        flash_attention_bwd.launches = 0
        comm.host_staged_bytes = 0
        losses, _ = ts_sgd(cfg, params0, tokens, mesh, steps=TS_ENV_STEPS)
        out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
               "backend": dist.get_backend(),
               "sizes": {name: mesh.size(i) for i, name in
                         enumerate(mesh.mesh_dim_names)},
               "losses": [float(x) for x in losses],
               "launches": {"fwd": flash_attention.launches,
                            "bwd": flash_attention_bwd.launches},
               "staged": comm.host_staged_bytes}
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def ts_env_world(out_dir: str) -> tuple[list, float]:
    """Two processes of this script (ts_env_rank) configured by the
    environment only; any failure or the deadline stops both. Returns
    their results and the seconds they took."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo")
    outs = [f"{out_dir}/env_rank{r}.json" for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-sharded-env",
         outs[r]],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=max(
                1.0, TS_TIMEOUT_S - (time.perf_counter() - t0)))
            if p.returncode:
                raise AssertionError(f"environment-configured rank {r} "
                                     f"failed:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results, time.perf_counter() - t0


def _ts_kernel_text(rows) -> str:
    """What the ranks' ts_kernel_checks read, the worst over the ranks."""
    from tiny_flash_attention_tpu_torch.utils.testing import (
        BF16_LSE_GATE, BF16_ROW_GATE)

    def worst(key):
        return max(r["kernels"]["fwd"][key] for r in rows)

    k = rows[0]["kernels"]
    text = (f"B1 q/kv {k['q']}/{k['kv']}: out {worst('out'):.3e} of max(1, "
            f"max |plain|) (up to {worst('scale'):.3f}), lse "
            f"{worst('lse'):.3e}")
    if "row" in k["fwd"]:
        text += (f", at the fold rows {worst('row'):.3e} (gate "
                 f"{BF16_ROW_GATE:.4e}) lse {worst('fold_lse'):.3e} (gate "
                 f"{BF16_LSE_GATE:.0e})")
    bwd = max(max(r["kernels"]["bwd"]) for r in rows)
    return (f"{text}; backward dq/dk/dv {bwd:.3e} of max |plain| (gate "
            f"{k['bwd_gate']:.0e})")


def sharded_train_phase() -> dict:
    """Each world of TS_WORLDS through parallel/world.py::run_world, every
    rank running ts_rank against the single-card step run first in this
    process (ts_reference), then the environment-configured world
    (ts_env_world). Gates: the world of 1 gives the single-card step's
    gradients, AdamW losses and every leaf after them bit for bit; the
    gloo worlds' gradients within TRAIN_GRAD_GATE (TRAIN_F32_GRAD_GATE in
    f32) of the single card's blocks by relative Frobenius distance, the
    first loss within TS_LOSS_GATE, the AdamW losses finite and falling;
    every rank's losses the same bits and its replicated leaves the same;
    B1 and the backward on each rank's inputs against their plain
    versions; each rank's B1 and backward launches n_layers a step; gloo
    staging positive, NCCL's 0; each planted fault over TS_FAULT_MARGIN
    times the gradient gate; the environment-configured world's losses
    within TS_LOSS_GATE of the single card's SGD losses. Returns the
    main-path launches summed over every rank of every world, by kernel
    row."""
    import tempfile

    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.parallel.world import run_world

    _build.build()      # a no-op after main()'s build
    card_settings()
    torch.cuda.empty_cache()
    totals = {"flash_fwd": 0, "flash_fwd_f32": 0, "flash_bwd": 0,
              "flash_bwd_f32": 0}
    failed = []
    layers = engine_config().n_layers       # every model of the phase's
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as ref_dir:
        refs = {model: ts_reference(model, ref_dir) for model in TS_SHAPES}
        torch.cuda.empty_cache()
        for n, backend, runs in TS_WORLDS:
            t0 = time.perf_counter()
            per_rank = run_world(ts_rank, n, backend=backend,
                                 device_type="cuda", args=(runs, refs),
                                 timeout_s=TS_TIMEOUT_S)
            log(f"sharded train: world of {n} on {backend} (one card), "
                f"{time.perf_counter() - t0:.1f} s with its spawn")
            for i, (model, shape, _) in enumerate(runs):
                rows = [ranks[i] for ranks in per_rank]
                ref = refs[model]
                f32 = model == "f32"
                gate = TRAIN_F32_GRAD_GATE if f32 else TRAIN_GRAD_GATE
                want = {"fwd": layers * TS_ADAMW_STEPS,
                        "bwd": layers * TS_ADAMW_STEPS}
                launches = [r["launches"] for r in rows]
                grad_err = max(r["grad_err"] for r in rows)
                loss_err = max(abs(r["sgd_loss"] - ref["sgd"][0])
                               / ref["sgd"][0] for r in rows)
                adamw = [float(x) for x in rows[0]["adamw"]]
                same = all(torch.equal(torch.stack(r["adamw"]),
                                       torch.stack(rows[0]["adamw"]))
                           and r["sgd_loss"] == rows[0]["sgd_loss"]
                           and r["replicated"] == rows[0]["replicated"]
                           for r in rows)
                staged = [r["staged"] for r in rows]
                kernels_ok = all(r["kernels"]["ok"] for r in rows)
                ok = (same and kernels_ok and all(x == want for x in launches)
                      and all(np.isfinite(adamw)) and adamw[-1] < adamw[0]
                      and (all(s > 0 for s in staged) if backend == "gloo"
                           else not any(staged)))
                if n == 1:
                    bits = (rows[0]["grad_bits"] and rows[0]["leaf_bits"]
                            and adamw == ref["adamw"])
                    ok = ok and bits
                    verdict = (f"gradients, AdamW losses and every leaf "
                               f"after them bit for bit: {bits}")
                else:
                    ok = ok and grad_err <= gate and loss_err <= TS_LOSS_GATE
                    verdict = (f"gradients vs the single card's blocks "
                               f"{grad_err:.3e} (relative Frobenius, worst "
                               f"leaf and rank; gate {gate:.0e}); first loss "
                               f"{loss_err:.3e} off (gate {TS_LOSS_GATE:.0e})")
                key = "_f32" if f32 else ""
                totals[f"flash_fwd{key}"] += sum(x["fwd"] for x in launches)
                totals[f"flash_bwd{key}"] += sum(x["bwd"] for x in launches)
                ms = [[round(w * 1e3, 1) for w in r["walls"]] for r in rows]
                tokens = TS_SHAPES[model][0] * TS_SHAPES[model][1]
                log(f"  [{model}] mesh (data, model) {shape}: {verdict}; "
                    f"AdamW losses {adamw} (single card {ref['adamw']}); "
                    f"ranks' losses and replicated leaves the same: {same} | "
                    f"launches by rank {launches} (expected {want} each) | "
                    f"{backend}, staged GB a step by rank "
                    f"{[round(s / TS_ADAMW_STEPS / 1e9, 3) for s in staged]} "
                    f"| {'ok' if ok else 'FAIL'}")
                log(f"    kernels against their plain versions on the "
                    f"ranks' inputs: {_ts_kernel_text(rows)} | "
                    f"{'ok' if kernels_ok else 'FAIL'}")
                log(f"    ranks time-sharing one card: wall ms a step by "
                    f"rank {ms} -> tokens/s by rank "
                    f"{[round(tokens / r['walls'][-1]) for r in rows]} (last "
                    f"step, {tokens} tokens); peak GiB by rank "
                    f"{[round(r['peak_gib'], 2) for r in rows]}; the single "
                    f"card {[round(x, 1) for x in ref['ms']]} ms a step")
                for fault in rows[0]["faults"]:
                    err = max(r["faults"][fault] for r in rows)
                    caught = err > TS_FAULT_MARGIN * gate
                    log(f"    planted fault '{fault}': gradients "
                        f"{err:.3e} ({err / gate:.1f}x the gate) | "
                        f"{'caught' if caught else 'NOT CAUGHT'}")
                    ok = ok and caught
                if not ok:
                    failed.append(f"{model} mesh {shape}")
        env, secs = ts_env_world(ref_dir)
        ref = refs["train"]["sgd"]
        env_err = max(abs(a - b) / b for r in env
                      for a, b in zip(r["losses"], ref))
        want = {"fwd": layers * TS_ENV_STEPS, "bwd": layers * TS_ENV_STEPS}
        ok = (all(r["sizes"] == {"data": 2, "model": 1}
                  and r["backend"] == "gloo" and r["world"] == 2
                  and r["launches"] == want and r["staged"] > 0
                  for r in env) and env_err <= TS_LOSS_GATE
              and env[0]["losses"] == env[1]["losses"])
        for r in env:
            totals["flash_fwd"] += r["launches"]["fwd"]
            totals["flash_bwd"] += r["launches"]["bwd"]
        log(f"sharded train: two processes configured by the environment "
            f"(initialize_multihost, gloo), make_hybrid_mesh(num_slices=2) "
            f"{env[0]['sizes']}: SGD losses {env[0]['losses']} vs the "
            f"single card {ref}, {env_err:.3e} off (gate "
            f"{TS_LOSS_GATE:.0e}); launches by rank "
            f"{[r['launches'] for r in env]} (expected {want}); staged GB "
            f"by rank {[round(r['staged'] / 1e9, 3) for r in env]}; "
            f"{secs:.1f} s with their start | {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append("environment-configured world")
    if failed:
        raise AssertionError(f"sharded train phase failed: {failed}")
    log(f"  sharded train main-path launches, every rank of every world: "
        f"{totals}; the phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": totals}


def build_report(names=None) -> None:
    """Builds the kernel sources (`names`, default all) in parallel and
    logs each one's nvcc seconds, its instances, their most registers and
    their spill bytes (ptxas), every instance's at sources of at most 40."""
    from tiny_flash_attention_tpu_torch import _build

    names = names or _build.sources()
    t_build = _build.build(names)
    log(f"build: {names} in {t_build:.1f} s (nvcc, parallel); "
        f"each source's nvcc, s: " + ", ".join(
            f"{name} {t:.1f}" for name, t in sorted(
                _build.build_seconds.items(), key=lambda x: -x[1])))
    for name in names:
        text = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                text))
        log(f"  {name}: {len(regs)} kernel instances, at most {max(regs)} "
            f"registers, {spills} bytes of spill stores in all (ptxas)")
        # every instance of the sources of at most 40 (the quantized
        # forward's 36 and FA1's 6 among them)
        if len(regs) <= 40:
            log("    registers/spill bytes: "
                + ", ".join(instance_registers(text)))
        elif spills:
            log("    instances that spill, registers/spill bytes: "
                + "; ".join(spilling_instances(text)))


# the sources the decode-widths phase and the OpenLLaMA-3B-width engines
# run: the decodes, the append, the flash forward (prefill)
WIDTH_SOURCES = ["paged_decode", "paged_decode_f32", "paged_decode_widths",
                 "paged_decode_widths_f32", "paged_decode_separate",
                 "paged_decode_separate_widths", "page_append", "flash_fwd"]


def widths_main() -> int:
    """`--decode-widths`: the decode-widths phase and the OpenLLaMA-3B-width
    engines alone (their sources built first)."""
    card_settings()
    log(f"card: {gpu_info()}")
    build_report(WIDTH_SOURCES)
    decode_widths_phase(torch.Generator(device="cuda").manual_seed(SEED + 2))
    dims_model_phase(SEED, models=[m for m in DIMS_MODELS
                                   if m[0] == WIDTH_MODEL], train=False)
    return 0


def wider_main() -> int:
    """`--wide`: the head_dim 257-512 phase and the DeepSeek-V4-Flash-width
    engines alone (their sources built first)."""
    card_settings()
    log(f"card: {gpu_info()}")
    build_report(WIDER_SOURCES)
    wider_phase(torch.Generator(device="cuda").manual_seed(SEED + 3))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; it runs on the card",
              file=sys.stderr)
        return 1
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.models.inference import (
        prefill_forward_batched)

    card_settings()

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    info = gpu_info()
    log(f"card: {info}")
    build_report()
    # the bf16-q instances of B1 (over bf16 K/V and over int8/e4m3
    # payloads, its wide head_dim-256 instances included), the bf16
    # backward's main kernels (the wide one included) and B14's bf16
    # instances (its wide one included) run on wgmma: HGMMA in their SASS,
    # no HMMA
    for lib, prefix in (("flash_fwd", "flash_fwd_wgmma_kernel"),
                        ("flash_fwd_quant", "flash_fwd_wgmma_kernel"),
                        ("flash_bwd", "flash_bwd_main_kernel"),
                        ("flash_bwd", "flash_bwd_wide_kernel"),
                        ("flash_bwd", "flash_bwd_512_kernel"),
                        ("flash_v1", "flash_v1_wgmma_kernel")):
        sass = {k: v for k, v in wgmma_instructions(
            str(_build._target(lib)[1])).items() if k.startswith(prefix)}
        log(f"  {lib} bf16 instances, HGMMA/HMMA instructions (cuobjdump "
            "-sass): " + ", ".join(f"{k}: {g}/{h}"
                                   for k, (g, h) in sass.items()))
        if not sass or any(g == 0 or h > 0 for g, h in sass.values()):
            raise AssertionError(f"{lib}'s bf16-q instances are not on "
                                 "wgmma")
    # shared memory: ops/configs.py's sizes are the kernels'
    from tiny_flash_attention_tpu_torch.ops.flash import check_smem_layouts
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
        check_bf16_smem, check_f32_smem)
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        check_smem_layout)
    for name, quantized in (("flash_fwd", False), ("flash_fwd_quant", True)):
        check_smem_layouts(_build.library(name), quantized)
    check_smem_layout(_build.library("flash_v1"))
    check_f32_smem(_build.library("flash_bwd"))
    check_bf16_smem(_build.library("flash_bwd"))
    log("  shared memory: ops/configs.py's fwd_smem_bytes, v1_smem_bytes, "
        "bwd_f32_smem_bytes and bwd_smem_bytes give each library's own size "
        "(tfa_flash_fwd_smem, tfa_flash_fwd_quant_smem, tfa_flash_v1_smem, "
        "tfa_flash_bwd_f32_smem, tfa_flash_bwd_bf16_smem) for every "
        "instance, the head_dim-256 ones included (the quantized forward's "
        "and FA1's too)")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32_fwd_row = None
    for case in FLASH_CASES:
        row = check_flash(*case, gen, iters=5 if case[1][2] >= 8192 else 10,
                          faults=case[4] and case[1][2] == case[2][2] and (
                              case[1][2] in (2048, 8192)
                              or case[1] == F32_FWD_SHAPE[0]))
        if case[1] == F32_FWD_SHAPE[0]:
            f32_fwd_row = row
    fwd_f32_split_sweep(gen)
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
    for name, k, n in QMM_SHAPES:
        check_qmm(f"{name}, 1 row", 1, k, n, "int8", gen)
    check_qmm("lm_head, fp8 weight", 8, 1024, 32768, "fp8", gen)
    check_qmm("w_down, 3 rows", 3, 4096, 1024, "int8", gen)
    qmm_row_sweep(gen)
    qmm_split_sweep(gen)
    bwd_rows = [check_bwd(*case, gen, iters=5 if case[1][2] >= 8192 else 10)
                for case in BWD_CASES]
    bwd_f32_split_sweep(gen)
    bwd_spread(gate=True)
    window_rows = {case[0]: check_window(*case, gen) for case in WINDOW_CASES}
    ring_rows = {fmt: check_ring(f"{fmt} pages, wrapped table", fmt, gen)
                 for fmt in ("bf16", "int8")}
    surface = surface_phase(gen)
    quant_flash = quant_flash_phase(gen)
    dims = dims_phase(gen)
    check_not_ported_raise()
    # the autotuner and the native CPU oracle, on a generator of their own
    # so that the phases after them take the inputs they always took
    aux_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    autotune_phase(aux_gen)
    cpu_oracle_phase(aux_gen)

    run = engine_phase(SEED)
    eng, cfg = run["engine"], run["cfg"]
    profile_window(f"per decode step (steps({PROFILE_STEPS}), 8 slots)",
                   lambda: eng.steps(PROFILE_STEPS), PROFILE_STEPS,
                   STEP_LAUNCHES["bf16"], watch="page_append")
    profile_window("per prefill of 4 x 2048 tokens",
                   lambda: prefill_forward_batched(cfg, eng.params,
                                                   run["long_tokens"]), 1)

    time_sampled_decode(eng, run["n_chunk"])

    quant = quant_serving_phase(SEED)
    ragged = ragged_admission_phase(SEED)
    enc = encoder_phase(SEED)
    swa = swa_phase(SEED)
    # after the serving phases' profiles: run before the engine phase, the
    # wide phase left two of the decode step's five small host-to-device
    # copies without a device record in every profile, the host's calls
    # and the kernels recorded the same (PERF.md, section 6); the launch
    # gates count device records
    wide = wide_phase(gen)
    # the DeepSeek-V4-Flash-width engines run in wider_phase, below
    dims_models = dims_model_phase(SEED, models=[m for m in DIMS_MODELS
                                                 if m[0] != V4_MODEL])
    dlaunch = dims_models["launches"]
    # the decodes and the append at every head_dim up to 256 and every page
    # size JAX takes, on a generator of their own (the phases after them
    # take the inputs they always took)
    widths = decode_widths_phase(
        torch.Generator(device="cuda").manual_seed(SEED + 2))
    # the Phi-3-mini-width runs launch the head_dim-96 instances; the
    # Llama-3.2-3B-width runs the head_dim-128 ones
    phi = dims_models["by_model"][DIMS_MODELS[0][0]]
    llama = dims_models["by_model"][DIMS_MODELS[1][0]]
    # ... and the Gemma-2B-width runs the head_dim-256 (wide) ones; the
    # OpenLLaMA-3B-width runs the run-time width instances (head_dim 100)
    gemma = dims_models["by_model"][DIMS_MODELS[2][0]]
    openllama = dims_models["by_model"][WIDTH_MODEL]
    wide_dec = dims_models["wide"]
    # the f32 path at head_dim 256: its kernels, then the Gemma-2B-width
    # model in f32, served and trained
    wide_f32 = wide_f32_phase(gen)
    f32_models = wide_f32_model_phase(SEED)
    f32_launch = f32_models["launches"]
    # head_dim 256 in the last two kernels that stopped at 128: the
    # quantized forward and FA1, through their package entries
    wide_qv = wide_quant_v1_phase(gen)
    wq_rows = wide_qv["rows"]
    # head dims 257-512: B1, B4, B12 and B5 on their instances of width 512
    # and the DeepSeek-V4-Flash-width engines, on a generator of their own
    wider = wider_phase(torch.Generator(device="cuda").manual_seed(SEED + 3))
    v4 = wider["models"]["by_model"][V4_MODEL]
    v4_dec = wider["models"]["wide"]
    from tiny_flash_attention_tpu_torch.ops.dims import (
        DECODE_TOP_512 as decode_top_512)
    werrs, wrows = wider["errs"], wider["rows"]
    from tiny_flash_attention_tpu_torch.ops.configs import (
        PAGED_DECODE_F32_WIDE_WARPS as f32_warps)

    train = train_phase(SEED)
    for label, (step, *state) in train["states"].items():
        profile_window(f"per train step of {label} tokens",
                       lambda f=step, s=state: f(*s), 1,
                       watch="flash_fwd_f32" if label.startswith("f32")
                       else None)
    # context parallel: ring, zigzag ring, Ulysses, all-gather and sharded
    # flash in worlds of ranks on this card, each on B1
    cp = context_parallel_phase()
    # sharded serving: the tensor- and data-parallel engine in worlds of
    # ranks on this card, on B1, B4 and B5
    slaunch = sharded_serving_phase()["launches"]
    # the sharded train step: data x tensor parallel in worlds of ranks on
    # this card and two processes configured by the environment, on B1 and
    # the backward kernels
    tlaunch = sharded_train_phase()["launches"]

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
        *(r["max_abs_err"] for r in window_rows.values()),
        dims["errs"]["flash_fwd"])
    f32_fwd_row["max_abs_err"] = max(f32_fwd_row["max_abs_err"],
                                     dims["errs"]["flash_fwd_f32"])
    rowloop_row = dict(slice_rows["jagged"])
    rowloop_row["max_abs_err"] = max(rowloop_row["max_abs_err"], rowloop_err)
    page_table, lengths = eng.cache.device_views()
    qd = randn((8, cfg.n_q_heads, cfg.d_head), torch.bfloat16, gen)
    decode_row = check_decode("main path: engine cache, layer 0", qd,
                              eng.cache.pages[0], lengths, page_table, 128,
                              faults=True)
    # the ring mode's errors join B4's row (bf16 pages) and its int8 row
    decode_row["max_abs_err"] = max(decode_row["max_abs_err"],
                                    ring_rows["bf16"]["max_abs_err"],
                                    dims["errs"]["paged_decode"])
    eng8k = quant["engines"][(False, 7936)]
    page_table, lengths = eng8k.cache.device_views()
    int8_row = check_decode("main path: int8 engine cache at prompt 7936, "
                            "layer 0", qd, eng8k.cache.pages[0], lengths,
                            page_table, 128, faults=True)
    decode_split_sweep("int8 engine cache at prompt 7936", qd,
                       eng8k.cache.pages[0], lengths, page_table, 128)
    int8_row["max_abs_err"] = max(int8_row["max_abs_err"],
                                  ring_rows["int8"]["max_abs_err"],
                                  dims["errs"]["paged_decode_int8"])
    qlaunch = quant["launches"]
    # B14's row: FA1 at the MHA headline shape, B12's: config 2 over bf16
    # pages; each with the worst error of its cases
    srows = surface["rows"]
    v1_row = dict(srows[V1_CASES[0][0]])
    v1_row["max_abs_err"] = max(dims["errs"]["flash_v1"], *(
        srows[c[0]]["max_abs_err"] for c in V1_CASES
        if c[3] == torch.bfloat16))
    v1_f32_row = dict(srows[next(c[0] for c in V1_CASES
                                 if c[3] == torch.float32)])
    b12_row = dict(srows[B12_CASES[0][0]])
    b12_row["max_abs_err"] = max(dims["errs"]["paged_decode_separate"], *(
        srows[c[0]]["max_abs_err"] for c in B12_CASES))
    v1_f32_row["max_abs_err"] = max(v1_f32_row["max_abs_err"],
                                    dims["errs"]["flash_v1_f32"])
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

    def bwd_kernel(part, row, dtype, launches, suffix=None, worst=None,
                   design=None):
        if worst is None:
            worst = max(r["max_abs_err"] for r, c in zip(bwd_rows, BWD_CASES)
                        if c[3] == dtype)
            if dtype == torch.bfloat16:
                worst = max(worst, dims["errs"]["flash_bwd"])
        if suffix is None:
            suffix = "_f32" if dtype == torch.float32 else ""
        design = ("bf16: prep; main on wgmma/TMA, one block per (128-row "
                  "kv tile, q head), longest band first, walking its q "
                  "tiles downward; dQ bulk-reduce-added in each q tile's "
                  "chain in kv-tile rank order (turn counters), dK/dV in "
                  "per-q-head f32 slots; post sums the GQA group in head "
                  "order: a fixed sum order, bit-identical runs"
                  if dtype == torch.bfloat16 else
                  "f32: CUDA cores (no TF32); dq and dk/dv kernels over "
                  "work lists that cut each 64-row tile's range at the "
                  "multiples of 8 tiles, one block per (run, q head, batch), "
                  "two halves of 128 threads (S/P and dV; dP/dS and dK), "
                  "8 x 4 and 8 x 8 register tiles fed by swizzled float4 "
                  "reads, a two-stage cp.async ring; slots summed by post "
                  "in a fixed order (items, then q heads): bit-identical "
                  "runs") if design is None else design
        return {"name": f"flash_bwd_{part}{suffix}", "route": "cuda",
                "design": design,
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
                     train["launches"]["flash_bwd"]
                     + llama.get("flash_bwd", 0) + tlaunch["flash_bwd"])
          for part in ("prep", "main", "post")),
        # the head_dim-96 instances (read in place, products of 96 columns)
        # at the Phi-3-mini-width train step's (1,32,2048,96)
        *(bwd_kernel(part, dims["flash_bwd"], torch.bfloat16,
                     phi["flash_bwd"], suffix="_d96")
          for part in ("prep", "main", "post")),
        # the wide instances (head_dim 256) at the Gemma-2B-width train
        # step's (1,8,2048,256)/(1,1)
        *(bwd_kernel(part, wide["flash_bwd"], torch.bfloat16,
                     gemma["flash_bwd"], suffix="_d256",
                     worst=wide["errs"]["flash_bwd"], design=(
                         "bf16 at head_dim 129-256 (tiles of 256 columns): "
                         "prep and post as at 128; main on wgmma/TMA, one "
                         "block per (64-row kv tile, q head), two "
                         "warpgroups splitting S^T/dP^T by q columns "
                         "(m64n32k16) and dK/dV/dQ by head dims (m64n128k16, "
                         "m64n64k16), P^T and dS^T exchanged as bf16 in "
                         "shared memory, one q-side stage (qs loaded ahead), "
                         "dQ added by float4 atomics in each q tile's chain "
                         "in rank order: bit-identical runs"))
          for part in ("prep", "main", "post")),
        *(bwd_kernel(part, f32_row, torch.float32,
                     train["launches"]["flash_bwd_f32"]
                     + tlaunch["flash_bwd_f32"])
          for part in ("dq", "dkv", "post")),
        # the wide f32 instances (head_dim 256) at the Gemma-2B-width f32
        # train step's (1,8,2048,256)/(1,1)
        *(bwd_kernel(part, wide_f32["flash_bwd"], torch.float32,
                     f32_models["train"]["flash_bwd"], suffix="_f32_d256",
                     worst=wide_f32["errs"]["flash_bwd"], design=(
                         "f32 at head_dim 129-256 (tiles of 256 columns): "
                         "dq and dk/dv kernels over work lists of 32-row "
                         "tiles on both sides (runs of 16 tiles, 512 rows), "
                         "one block per (run, q head, batch), two halves of "
                         "128 threads (S/P and dV; dP/dS and dK), 4 x 2 "
                         "score and 4 x 16 dK/dV register tiles, dQ's 256 "
                         "threads over two 128-column parts; a two-stage "
                         "cp.async ring; slots summed by post in a fixed "
                         "order: bit-identical runs"))
          for part in ("dq", "dkv", "post")),
        # the instances of width 512 at the DeepSeek-V4-Flash-width train
        # step's (1,64,2048,512)/(1,1)
        *(bwd_kernel(part, wrows["bwd"]["DeepSeek-V4-Flash train step"],
                     torch.bfloat16, v4["flash_bwd"], suffix="_d512",
                     worst=werrs["flash_bwd"], design=(
                         "bf16 at head_dim 257-512 (tiles of 512 columns): "
                         "prep with two 16-byte pieces a lane, a warp a "
                         "row; main on wgmma/TMA, two blocks per (64-row kv "
                         "tile, q head), one for each 256-column half of "
                         "dK/dV/dQ, both recomputing S^T and dP^T over 512 "
                         "columns (m64n16k16 over 32 k-steps, a warpgroup "
                         "16 of the 32-row q step), P and dS as bf16 in "
                         "shared memory [q][kv], dV/dK m64n128k16 (64 + 64 "
                         "f32 registers a thread), dQ^T = K^T dS^T "
                         "(m64n32k16) added by float4 atomics in each (q "
                         "tile, part)'s chain: 7 products a pair, bit-"
                         "identical runs; post transposes dq"))
          for part in ("prep", "main", "post"))]
    # flash_fwd runs on every main path but the jagged admission: its
    # launches are the engines' (the windowed one's included), the
    # encoder's, the train step's and every rank's of the context-parallel
    # worlds; paged_decode's include the windowed engine's ring-mode
    # launches
    fwd_replaces = ("tiny_flash_attention_tpu/ops/flash.py:533; "
                    "tiny_flash_attention_tpu/ops/flash_tri.py:336; "
                    "tiny_flash_attention_tpu/ops/flash_tri.py:658")
    f32_design = ("f32 on the CUDA cores (no TF32): each 128-row q tile's "
                  "kv range cut at the multiples of S kv tiles into runs, "
                  "one block per (run, q head, batch), longest first; the "
                  "last run of a tile to arrive merges the partials in run "
                  "order (exact LSE combine); 256 threads, 8 x 4 score and "
                  "8 x 8 output register tiles fed by swizzled float4 "
                  "reads, a two-stage cp.async K/V ring")
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "design": "bf16: wgmma and a TMA/mbarrier ring, 128-row q and kv "
                   "tiles, two consumer warpgroups and a producer warpgroup "
                   "(setmaxnreg); f32: flash_fwd_f32",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": fwd_replaces,
         "launches": run["launches"]["flash_fwd"] + qlaunch["flash_fwd"]
         + ragged["launches"]["flash_fwd"] + enc["launches"]
         + train["launches"]["flash_fwd"] + swa["launches"]["flash_fwd"]
         + llama["flash_fwd"] + cp["launches"] + slaunch["flash_fwd"]
         + tlaunch["flash_fwd"],
         **flash_row},
        {"name": "flash_fwd_d96", "route": "cuda",
         "design": "the bf16 kernel at head_dim 96 read in place: tensor "
                   "maps of the true width (TMA lands zeros past column "
                   "96), S over 6 k-steps, PV as m64n96k16 (a 48-float "
                   "O), the epilogue storing 96 columns at stride 96; no "
                   "pad or slice copy",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": fwd_replaces, "launches": phi["flash_fwd"],
         **dims["flash"]},
        {"name": "flash_fwd_d256", "route": "cuda",
         "design": "the bf16 kernel's wide instance (head dims 129-256 read "
                   "in place, tiles of four 64-column boxes): 128 q rows, "
                   "64-row kv tiles in a two-stage TMA ring whose K and V "
                   "slots are released apart (K once its softmax has read "
                   "it), S as m64n64k16 over 16 k-steps, PV as m64n256k16 "
                   "(a 128-float O), the ping-pong and the intra-warpgroup "
                   "overlap kept",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": fwd_replaces, "launches": gemma["flash_fwd"],
         **wide["flash"], "max_abs_err": wide["errs"]["flash_fwd"]},
        {"name": "flash_fwd_f32", "route": "cuda", "design": f32_design,
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": fwd_replaces,
         "launches": train["launches"]["flash_fwd_f32"]
         + slaunch["flash_fwd_f32"] + tlaunch["flash_fwd_f32"],
         **f32_fwd_row},
        {"name": "flash_fwd_f32_d256", "route": "cuda",
         "design": "f32's wide instance (head dims 129-256, tiles of 256 "
                   "columns; 192 padded): 64-row q and 32-row kv tiles "
                   "(a 128-row q tile alone is 128 KiB there), 4 x 2 score "
                   "and 4 x 16 output register tiles a thread, the kv runs, "
                   "the in-order merge (slots of 64 x 258 floats), every "
                   "mask and the jagged mode of the 128 instance",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": fwd_replaces, "launches": f32_launch["flash_fwd"],
         **wide_f32["flash"], "max_abs_err": wide_f32["errs"]["flash_fwd"]},
        {"name": "flash_rowloop", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash_rowloop.py:332",
         "launches": ragged["launches"]["flash_rowloop"]
         + slaunch["flash_rowloop"], **rowloop_row},
        {"name": "paged_decode", "route": "cuda",
         "design": DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": run["launches"]["paged_decode"]
         + qlaunch["paged_decode"] + ragged["launches"]["paged_decode"]
         + swa["launches"]["paged_decode_ring"] + dlaunch["paged_decode"]
         - gemma["paged_decode"] - openllama["paged_decode"]
         + slaunch["paged_decode"], **decode_row},
        {"name": "paged_decode_d256", "route": "cuda",
         "design": "head_dim 256 over bf16 pages: 32 KiB a warp's stage, "
                   "each lane 32 elements of a row scored in four 16-byte "
                   "pieces and 8 contiguous output columns, q in shared "
                   "memory above G 2; " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": gemma["paged_decode"], **wide_dec["bf16"]["rows"][8],
         "max_abs_err": max(wide["errs"]["ring"], *(
             r["max_abs_err"] for r in wide_dec["bf16"]["rows"].values()))},
        {"name": "paged_decode_int8_d256", "route": "cuda",
         "design": "head_dim 256 over int8 pages (two 16,640-byte stages a "
                   "warp); " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": gemma["paged_decode_int8"],
         **wide_dec["int8"]["rows"][8],
         "max_abs_err": max(r["max_abs_err"]
                            for r in wide_dec["int8"]["rows"].values())},
        *bwd_kernels,
        {"name": "paged_decode_int8", "route": "cuda",
         "design": "int8 pages, scale rows by bulk copy, exact "
                   "byte-permute conversion; " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": qlaunch["paged_decode_int8"]
         + dlaunch["paged_decode_int8"] - gemma["paged_decode_int8"]
         - openllama["paged_decode_int8"]
         + slaunch["paged_decode_int8"], **int8_row},
        {"name": "page_append", "route": "cuda",
         "source": "tiny_flash_attention_tpu_torch/csrc/page_append.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:281",
         "launches": run["launches"]["page_append"]
         + qlaunch["page_append"] + ragged["launches"]["page_append"]
         + swa["launches"]["page_append"] + dlaunch["page_append"]
         - gemma["page_append"] - openllama["page_append"]
         + slaunch["page_append"],
         **append_rows[("int8", 128)],
         "max_abs_err": max(append_rows[("int8", 128)]["max_abs_err"],
                            dims["errs"]["page_append"])},
        {"name": "paged_decode_widths", "route": "cuda",
         "design": "bf16 pages at a head_dim or page size without an "
                   "instance of its own: " + WIDTHS_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_widths.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": openllama["paged_decode_widths"],
         **dims_models["caches"][WIDTH_MODEL],
         "max_abs_err": max(
             dims_models["caches"][WIDTH_MODEL]["max_abs_err"],
             *widths["worst"]["B4 bf16"][::2],
             *widths["worst"]["B4 bf16 ring"][::2],
             *widths["worst"]["B4 f32"][::2])},
        {"name": "paged_decode_int8_widths", "route": "cuda",
         "design": "int8 pages at a head_dim or page size without an "
                   "instance of its own: " + WIDTHS_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_widths.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": openllama["paged_decode_int8_widths"],
         **dims_models["int8_caches"][WIDTH_MODEL],
         "max_abs_err": max(
             dims_models["int8_caches"][WIDTH_MODEL]["max_abs_err"],
             *widths["worst"]["B4 int8"][::2],
             *widths["worst"]["B4 int8 ring"][::2])},
        {"name": "page_append_widths", "route": "cuda",
         "design": "a head_dim with no instance of its own (any up to 256, "
                   "read at run time): a warp per (kv head, sequence), the "
                   "values lane, lane + 32, ... below d, int8 scale bytes "
                   "at row 2ps + 4 (row / d) + j, lane row % d",
         "source": "tiny_flash_attention_tpu_torch/csrc/page_append.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:281",
         "launches": openllama["page_append_widths"],
         **widths["appends"]["int8 d 100 ps 100"],
         "max_abs_err": max(widths["worst"][f"B5 {f}"][0]
                            for f in ("bf16", "f32", "int8"))},
        {"name": "paged_decode_separate_widths", "route": "cuda",
         "design": "separate K/V page arrays at a head_dim or page size "
                   "without an instance of its own: " + WIDTHS_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_separate_widths.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged.py:327",
         "launches": widths["b12_launches"], **widths["b12"]},
        {"name": "paged_decode_f32_d256", "route": "cuda",
         "design": "f32 q over f32 pages at head_dim 256: a warp's "
                   "32-token stage is 64 KiB, so a block has "
                   f"{f32_warps} warps ({f32_warps * 65536:,} bytes of "
                   "rings), a group of 8 as two G-4 row blocks; "
                   + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode_f32.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": f32_launch["paged_decode"],
         **f32_models["decode"]["bf16"]["rows"][8],
         "max_abs_err": max(wide_f32["errs"]["ring"], *(
             r["max_abs_err"]
             for r in f32_models["decode"]["bf16"]["rows"].values()))},
        {"name": "paged_decode_int8_f32q_d256", "route": "cuda",
         "design": "f32 q over int8 pages at head_dim 256 (two 16,640-byte "
                   "stages a warp, four warps); " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode_f32.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": f32_launch["paged_decode_int8"],
         **f32_models["decode"]["int8"]["rows"][8],
         "max_abs_err": max(
             r["max_abs_err"]
             for r in f32_models["decode"]["int8"]["rows"].values())},
        {"name": "page_append_f32_d256", "route": "cuda",
         "design": "f32 rows into f32 pages at head_dim 256: a warp per "
                   "(kv head, sequence), 8 contiguous values a lane",
         "source": "tiny_flash_attention_tpu_torch/csrc/page_append.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:281",
         "launches": f32_launch["page_append"],
         **wide_f32["append"]["bf16"],
         "max_abs_err": wide_f32["errs"]["page_append"]},
        {"name": "page_append_d256", "route": "cuda",
         "design": "head_dim 256: a warp per (kv head, sequence), 8 "
                   "contiguous values a lane",
         "source": "tiny_flash_attention_tpu_torch/csrc/page_append.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:281",
         "launches": gemma["page_append"],
         **wide["append"][("int8", 128)],
         "max_abs_err": wide["errs"]["page_append"]},
        {"name": "flash_fwd_d512", "route": "cuda",
         "design": "the bf16 kernel's instance of width 512 (head dims "
                   "257-512 read in place, tiles of eight 64-column boxes): "
                   "64 q rows that both consumer warpgroups take, each "
                   "computing the whole S (m64n32k16 over 32 k-steps) and "
                   "the PV products of its 256-column half of O "
                   "(m64n256k16, 128 floats a thread); 32-row kv tiles in "
                   "a two-stage TMA ring whose K and V slots are released "
                   "apart (197,960 bytes); the first half writes the LSE",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": fwd_replaces, "launches": v4["flash_fwd"],
         **wrows["flash"]["DeepSeek-V4-Flash prefill"],
         "max_abs_err": werrs["flash_fwd"]},
        {"name": "paged_decode_d512", "route": "cuda",
         "design": "head dims 257-512 over bf16 pages on instances of width "
                   "512 (compiled at 512, run-time widths below): a warp's "
                   "32-token stage is 64 KiB, so a block has 3 warps; each "
                   "lane scores 64 elements of a row in eight 16-byte "
                   "pieces and owns 16 output columns; groups as row "
                   f"blocks of {decode_top_512} q rows; " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode_wide.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": v4["paged_decode"], **v4_dec["bf16"]["rows"][64],
         "max_abs_err": max(werrs["paged_decode"], *(
             r["max_abs_err"] for r in v4_dec["bf16"]["rows"].values()))},
        {"name": "paged_decode_int8_d512", "route": "cuda",
         "design": "head dims 257-512 over int8 pages (two 33,024-byte "
                   "stages a warp, 3 warps a block); " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/paged_decode_wide.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:535",
         "launches": v4["paged_decode_int8"], **v4_dec["int8"]["rows"][64],
         "max_abs_err": max(werrs["paged_decode_int8"], *(
             r["max_abs_err"] for r in v4_dec["int8"]["rows"].values()))},
        {"name": "paged_decode_separate_d512", "route": "cuda",
         "design": "separate K/V page arrays at head dims 257-512 on B4's "
                   "template at width 512; " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_separate_wide.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged.py:327",
         **wrows["b12"]["bf16"],
         "launches": sum(r["launches"] for r in wrows["b12"].values()),
         "max_abs_err": werrs["paged_decode_separate"]},
        {"name": "page_append_d512", "route": "cuda",
         "design": "head_dim 512 (16 contiguous values a lane) and every "
                   "other head_dim in 257-511 on a run-time instance (16 "
                   "values a lane, lane + 32 e); a warp per (kv head, "
                   "sequence)",
         "source": "tiny_flash_attention_tpu_torch/csrc/page_append.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged_fused.py:281",
         "launches": v4["page_append"], **wrows["append"][("int8", 128)],
         "max_abs_err": werrs["page_append"]},
        {"name": "quant_matmul", "route": "cuda",
         "design": "bf16 x: mma.sync m16n8k16 on the tensor cores with the "
                   "weight as the 16-row operand (out^T = w^T x^T), payload "
                   "converted exactly in registers by byte permutes (int8) "
                   "or the e4m3x2 convert, a 4-stage cp.async ring of 64 x "
                   "128-byte weight tiles, x staged once per block, a "
                   "persistent grid over 128-column tiles, K split over a "
                   "cluster where N is small; f32 x: CUDA cores",
         "source": "tiny_flash_attention_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "tiny_flash_attention_tpu/ops/quant_matmul.py:84",
         "launches": qlaunch["quant_matmul"],
         **{k: v for k, v in qmm_rows["lm_head"].items() if k != "route_ms"}},
        {"name": "flash_v1", "route": "cuda",
         "design": "bf16: FA1's loop order (kv tiles outer, q tiles inner, "
                   "every q tile's state reloaded and stored back on each "
                   "kv step, in fragment order) on wgmma and TMA: a "
                   "producer warpgroup streams K/V through a two-stage "
                   "ring and the q tiles through a two-stage ring of their "
                   "own, two consumer warpgroups of 64 q rows; two 128-row "
                   "q tiles a block, dealt longest first in snake order",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_v1.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash_v1.py:144",
         "launches": surface["launches"]["flash_v1"],
         **{k: v for k, v in v1_row.items() if k != "fa2_ms"}},
        {"name": "flash_v1_f32", "route": "cuda",
         "design": "f32 on the CUDA cores (no TF32), FA1's order and state "
                   "round trip kept: 17 warps a block, two 64-row q tiles "
                   "from the snake schedule (128 blocks at (2,8,1024)); "
                   "two S groups of 128 threads take the steps in turn (8 "
                   "x 4 score tiles, the tile's own max and sum), a PV "
                   "group of 256 (8 x 4 output tiles) merges each step "
                   "into the state it reloads and stores back (its own "
                   "coalesced slots), a loader warp streams K and q by "
                   "cp.async into swizzled rings on mbarriers",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_v1.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash_v1.py:144",
         "launches": surface["launches"]["flash_v1_f32"],
         **{k: v for k, v in v1_f32_row.items() if k != "fa2_ms"}},
        {"name": "paged_decode_separate", "route": "cuda",
         "design": "separate K/V page arrays on B4's template; "
                   + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_separate.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged.py:327",
         "launches": surface["launches"]["paged_decode_separate"],
         **b12_row},
        {"name": "paged_decode_separate_d256", "route": "cuda",
         "design": "separate K/V page arrays at head_dim 256 on B4's "
                   "template; " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_separate.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged.py:327",
         **wide["b12"]["bf16"],
         "launches": sum(r["launches"] for r in wide["b12"].values()),
         "max_abs_err": wide["errs"]["paged_decode_separate"]},
        {"name": "paged_decode_separate_f32_d256", "route": "cuda",
         "design": "separate K/V page arrays at head_dim 256, f32 q over "
                   f"f32 pages (blocks of {f32_warps} warps) and int8 "
                   "pages; "
                   "B4's template; " + DECODE_DESIGN,
         "source": "tiny_flash_attention_tpu_torch/csrc/"
                   "paged_decode_separate.cu",
         "replaces": "tiny_flash_attention_tpu/ops/paged.py:327",
         **wide_f32["b12"]["bf16"],
         "launches": sum(r["launches"] for r in wide_f32["b12"].values()),
         "max_abs_err": wide_f32["errs"]["paged_decode_separate"]},
        *({"name": f"flash_fwd_quant_{fmt}", "route": "cuda",
           "design": "bf16 q: B1's wgmma/TMA kernel (flash_fwd_wgmma.cuh); "
                     "its producer warpgroup bulk-copies each payload tile "
                     "into the second half of its ring stage and expands "
                     "it in place into the swizzled bf16 tile, two bytes "
                     "an instruction; the consumers read the per-token "
                     "scales through L1",
           "source": "tiny_flash_attention_tpu_torch/csrc/"
                     "flash_fwd_quant.cu",
           "replaces": "tiny_flash_attention_tpu/ops/flash.py:533; "
                       "tiny_flash_attention_tpu/ops/flash_tri.py:336; "
                       "tiny_flash_attention_tpu/ops/flash_tri.py:658",
           "launches": quant_flash["launches"][fmt],
           **{k: v for k, v in quant_flash["rows"][fmt].items()
              if k != "b1_ms"},
           "max_abs_err": max(quant_flash["rows"][fmt]["max_abs_err"],
                              dims["errs"][f"flash_fwd_quant_{fmt}"])}
          for fmt in ("int8", "fp8")),
        *({"name": f"flash_fwd_quant_{fmt}_f32q", "route": "cuda",
           "design": "f32 q: " + f32_design + "; each payload tile loaded "
                     "into registers a step ahead and converted exactly "
                     "into its ring stage",
           "source": "tiny_flash_attention_tpu_torch/csrc/"
                     "flash_fwd_quant.cu",
           "replaces": fwd_replaces,
           "launches": quant_flash["launches"][f"{fmt}_f32q"],
           **quant_flash["rows"][f"{fmt}_f32q"]}
          for fmt in ("int8", "fp8")),
        *({"name": f"flash_fwd_quant_{fmt}_d256", "route": "cuda",
           "design": "bf16 q at head dims 129-256 (padded to 256, payloads "
                     "with code 0): B1's wide wgmma/TMA instance, 64-row "
                     "kv tiles in a two-stage ring whose K and V slots "
                     "are released apart; each 16 KiB payload tile lands "
                     "in blocks 2-3 of its slot on a barrier of its own "
                     "(K's, V's) and the producer expands blocks 0-1, "
                     "then, from registers, 2-3; producer 56 registers, "
                     "consumers 224",
           "source": "tiny_flash_attention_tpu_torch/csrc/"
                     "flash_fwd_quant.cu",
           "replaces": fwd_replaces,
           "launches": wide_qv["launches"][fmt],
           **{k: v for k, v in wq_rows[fmt].items() if k != "b1_ms"}}
          for fmt in ("int8", "fp8")),
        *({"name": f"flash_fwd_quant_{fmt}_f32q_d256", "route": "cuda",
           "design": "f32 q at head dims 129-256 (padded to 256): the wide "
                     "f32 body (64-row q, 32-row kv tiles, the kv runs "
                     "merged in order), each payload tile loaded into "
                     "registers a step ahead (two 16-byte chunks a "
                     "thread) and converted exactly into its ring stage",
           "source": "tiny_flash_attention_tpu_torch/csrc/"
                     "flash_fwd_quant.cu",
           "replaces": fwd_replaces,
           "launches": wide_qv["launches"][f"{fmt}_f32q"],
           **{k: v for k, v in wq_rows[f"{fmt}_f32q"].items()
              if k != "b1_ms"}}
          for fmt in ("int8", "fp8")),
        {"name": "flash_v1_d256", "route": "cuda",
         "design": "bf16 at head dims 129-256 (padded to 256), FA1's order "
                   "and state round trip kept on wgmma/TMA: 128-row q "
                   "tiles, 64-row kv tiles (S as m64n64k16, PV as "
                   "m64n256k16, a 128-float O reloaded from its state "
                   "slot each step), K/V in a two-stage ring and the q "
                   "tile in one stage (197,696 bytes)",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_v1.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash_v1.py:144",
         "launches": wide_qv["launches"]["v1"],
         **{k: v for k, v in wq_rows["v1"].items() if k != "b1_ms"}},
        {"name": "flash_v1_f32_d256", "route": "cuda",
         "design": "f32 at head dims 129-256 (padded to 256), FA1's order "
                   "kept on the CUDA cores: 32-row q and kv tiles "
                   "(205,408 bytes), the 17 warps' roles of the 128 "
                   "instance with their maps scaled (4 x 2 scores an S "
                   "thread, 8 x 4 outputs a PV thread, a row group over "
                   "two warps, each keeping its copy of the rows' (m, l))",
         "source": "tiny_flash_attention_tpu_torch/csrc/flash_v1.cu",
         "replaces": "tiny_flash_attention_tpu/ops/flash_v1.py:144",
         "launches": wide_qv["launches"]["v1_f32"],
         **{k: v for k, v in wq_rows["v1_f32"].items() if k != "b1_ms"}},
    ]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched in the run: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--bwd-spread"]:
        # only the spread reading, with the package found on sys.path (so
        # a copy of this script can read another tree's kernels)
        if not torch.cuda.is_available():
            sys.exit(1)
        bwd_spread(gate=False)
        sys.exit(0)
    if sys.argv[1:] == ["--rows"]:
        # only the head_dim-128 rows this tree must keep, with the package
        # found on sys.path (so that one call can time two trees' kernels)
        if not torch.cuda.is_available():
            sys.exit(1)
        sys.exit(main_path_rows(SEED))
    if sys.argv[1:] in (["--autotune"], ["--cpu-oracle"]):
        # only the autotuner's phase, or only the CPU oracle's
        if not torch.cuda.is_available():
            sys.exit(1)
        from tiny_flash_attention_tpu_torch import _build

        log(f"card: {gpu_info()}")
        t_build = _build.build(["flash_fwd", "flash_fwd_quant"])
        log(f"build: flash_fwd, flash_fwd_quant in {t_build:.1f} s")
        phase = (autotune_phase if sys.argv[1] == "--autotune"
                 else cpu_oracle_phase)
        phase(torch.Generator(device="cuda").manual_seed(SEED + 1))
        sys.exit(0)
    if sys.argv[1:] == ["--wide"]:
        # only the head_dim 257-512 phase and the DeepSeek-V4-Flash-width
        # engines
        if not torch.cuda.is_available():
            sys.exit(1)
        sys.exit(wider_main())
    if sys.argv[1:] == ["--decode-widths"]:
        # only the decode-widths phase and the OpenLLaMA-3B-width engines
        if not torch.cuda.is_available():
            sys.exit(1)
        sys.exit(widths_main())
    if sys.argv[1:] == ["--cp"]:
        # only the context-parallel phase (its worlds build the kernels)
        if not torch.cuda.is_available():
            sys.exit(1)
        log(f"card: {gpu_info()}")
        context_parallel_phase()
        sys.exit(0)
    if sys.argv[1:] == ["--serve-sharded"]:
        # only the sharded-serving phase (its worlds build the kernels)
        if not torch.cuda.is_available():
            sys.exit(1)
        log(f"card: {gpu_info()}")
        sharded_serving_phase()
        sys.exit(0)
    if sys.argv[1:] == ["--train-sharded"]:
        # only the sharded-train phase (its worlds build the kernels)
        if not torch.cuda.is_available():
            sys.exit(1)
        log(f"card: {gpu_info()}")
        sharded_train_phase()
        sys.exit(0)
    if sys.argv[1:2] == ["--train-sharded-env"] and len(sys.argv) == 3:
        # one process of the phase's environment-configured world
        if not torch.cuda.is_available():
            sys.exit(1)
        ts_env_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:] == ["--bwd"]:
        # only the bf16 backward at the train steps' shapes (4 x 2048,
        # 1 x 8192, the window) and the spread gate, with the package found
        # on sys.path (so that one call can time two trees' kernels)
        if not torch.cuda.is_available():
            sys.exit(1)
        from tiny_flash_attention_tpu_torch import _build

        bwd_gen = torch.Generator(device="cuda").manual_seed(SEED)
        for case in BWD_CASES:
            if case[1][2] == case[2][2] >= 2048 and "mix" not in case[5]:
                check_bwd(*case, bwd_gen, iters=10)
        bwd_spread(gate=True)
        log("  flash_bwd registers/spill bytes: " + ", ".join(
            instance_registers(_build.build_log("flash_bwd"))))
        sys.exit(0)
    sys.exit(main())
