"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test skips where no CUDA card is present (this decision
is taken inside the fixture, never at import). On a machine with a card and
without JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(the repository's conftest imports JAX to pin it to the CPU). The shapes
here are the odd ones chip_smoke.py does not reach: ragged tiles, head_dim
64, every supported GQA group, f32, length 0 and sliced page tables, int8
pages of each geometry, the append in both formats, the quantized matmul at
1 to 16 rows, ragged N and K, fp8 weights, segment ids with boundaries off
the tile edges, jagged lengths around a tile, the FA1 kernel, the
separate-array decode in both formats, the sliding window (1, off the
tiles, wider than the sequence) and the decode's ring mode over wrapped
tables, and the quantized forward (int8 and e4m3 K/V with per-token
scales) at lengths 97/130/300, head_dim 64/128, groups 1/2/4, bf16 and f32
q, with the window, segment ids, segment_starts, the decode offset and
empty rows; and the bf16 forward at the edges of its 128-row tiles: q and
kv lengths 1/127/128/129/255/257, head_dim 64/128 at groups 1/2/4/8, one
and 130 decode rows over 2100, window edges at columns 127 and 129, ids
changing across the tile edge (bulk-copied and loaded), and jagged lengths
0/1/127/128/129. Then the bf16 backward bit for bit across runs under
every mask at groups 1 and 4, the quantized matmul's conversion of all 256
int8 and e4m3 codes and its every engine projection at 1 to 8 rows, and
the split decode (fused and separate pages) at several split counts
against its split plain version, a split past the lengths and a wrapped
ring included. Last, B1's f32 instance over its kv runs: bit-identical
calls under every mask, runs of 1 to 16 tiles against the plain version
(segment_starts changing no bit), f32 q over int8 and e4m3 payloads at
the edges of its tiles; and 1,000 appends, each right after a kernel that
writes its rows, bit for bit against the plain version. Last, the head dims
and groups no instance compiles (ops/dims.py): B1 at head_dim 72/80/96 and
groups 1/3/7 under each mask, its quantized instances, the backward and
autograd, FA1 at 80/96, the fused decode at 80/96 and groups 3/5/7/12/16
over bf16, f32 and int8 pages (the ring mode; int8 scale rows split over two
groups at page size 160), the separate decode, and the append bit for bit;
and the shapes that stay out raise (head_dim 264 in every flash entry, FA1
and the quantized forward included, the decodes and the append; int8
fused pages of page size 48 at head_dim 36, as in JAX). Last,
the head dims that the bf16 forward and
backward read in place (32, 48, 72, 80, 96 at groups 1, 3, 7 under every
mask, 300 rows): their results bit for bit those of the call on padded
tensors, with no pad copy; the instances of width 80 and 96 bit for bit
the 128-wide one; and the f32 and quantized forward still padding. Then
head_dim 256 in f32: B1's wide f32 instance (each mask and group, 192
padded, the edges of its 64-row q and 32-row kv tiles, the jagged mode,
bit-identical calls, its merge workspace), the f32 backward (each mask,
autograd, bit-identical runs), the decodes with f32 q over f32 and int8
pages (groups 1 to 12, the ring mode), the separate decode and the append
into f32 pages. Then head_dim 256 in the quantized forward (bf16 and f32
q over int8 and e4m3, each mask, bit-identical calls) and FA1 (bf16 and
f32, around the wide tiles, bit-identical calls), 192 through the padded
route giving the 256 call's bits on its true columns, and their shared
memory against ops/configs.py. Last, context parallelism (parallel/):
a world of 2 ranks sharing the card over gloo, ring (causal and not) and
zigzag against the plain version and B1 over the whole sequence; a world of 1 on NCCL giving
B1's bits in every mode; NCCL with two ranks on one card raising; a ring
backward on the card raising (its flash calls are forward-only); and a
failing rank failing its world. Last, sharded serving (parallel/serve.py):
a world of 1 on NCCL whose sharded engine gives the single-card engine's
greedy tokens and page bits, over bf16 and int8 pages. Last, the decodes
and the append at every head_dim up to 256 and every page size JAX takes
(the run-time width instances, ops/dims.py::decode_width): B4, B12 and B5
over bf16 pages at each head_dim 1 to 256; f32 and int8 pages at page
sizes 1, 8, 24, 48 and 100 and head dims 8 to 248; and the compiled widths
(64, 80, 96, 128, 256 at page size 16 or a multiple of 32) still on their
own instances. Last, the bf16 backward's instance of width 512 (head dims
264, 384 and 512 at groups 1, 8 and 64 under every mask, 300 rows; 264,
392 and 448 read in place with the padded call's bits; bit-identical runs
and chain counters at 0 among the runs above) and its refusals above 512
and in f32 above 256. Last, head dims 257-512 in f32: B1's f32 instance of
width 512 (264, 384, 448 and 512 padded to it, groups 1, 8 and 64 under
every mask, the edges of its 32-row tiles, the jagged mode, bit-identical
calls, its merge workspace), the decodes with f32 q over f32 and int8
pages (compiled and run-time widths, the ring, the separate pages), and a
backward() through B1 in f32 at 384 raising.
"""

import dataclasses

import pytest
import torch

import torch_parallel_ranks as RK
import torch_serve_ranks as SR
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    BwdLaunch, flash_attention_bwd, flash_attention_bwd_plain)
from tiny_flash_attention_tpu_torch.ops.flash_quant import (
    flash_attention_quantized, flash_attention_quantized_plain)
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop, flash_attention_rowloop_plain)
from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
    flash_attention_v1, flash_attention_v1_plain)
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
from tiny_flash_attention_tpu_torch.ops import configs, quant as Q
from tiny_flash_attention_tpu_torch.ops.dims import (
    DECODE_HEAD_DIMS, decode_compiled, kernel_head_dim, pad_head_dim,
    unpad_head_dim)
from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    decode_splits, fused_page_append, fused_paged_decode_attention,
    fused_paged_decode_plain, pack_paged_cache, page_append_plain, page_rows)
from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
    quantized_matmul_cuda, quantized_matmul_plain)
from tiny_flash_attention_tpu_torch.parallel.world import run_world
from tiny_flash_attention_tpu_torch.utils.testing import (
    BF16_ROW_GATE, flash_gate, fold_q, row_err, tolerance_for)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _assert_flash_gate(out, lse, plain, q, dtype):
    """B1 against its plain version, plain(q', sm_scale): the dtype gate
    and, for bf16, the gate at the kernel's q fold (utils/testing.py)."""
    errs, folded, ok = flash_gate(out, lse, plain, q, dtype)
    assert ok, (errs, folded)


@pytest.mark.parametrize("b,hq,hkv,q_len,kv_len,d,causal,dtype", [
    (1, 4, 2, 64, 64, 128, True, torch.bfloat16),
    (2, 8, 2, 300, 300, 128, True, torch.bfloat16),
    (1, 4, 2, 100, 260, 64, True, torch.bfloat16),
    (1, 4, 2, 200, 70, 128, True, torch.bfloat16),     # empty leading rows
    (2, 8, 2, 700, 700, 128, False, torch.bfloat16),
    (1, 4, 4, 65, 65, 64, False, torch.float32),
    (1, 4, 2, 130, 130, 128, True, torch.float32),
    (1, 4, 2, 200, 70, 64, True, torch.float32),
    (1, 2, 2, 1, 333, 128, True, torch.bfloat16),      # one decode row
])
def test_flash_kernel_matches_plain(gen, b, hq, hkv, q_len, kv_len, d,
                                    causal, dtype):
    q = _randn((b, hq, q_len, d), dtype, gen)
    k = _randn((b, hkv, kv_len, d), dtype, gen)
    v = _randn((b, hkv, kv_len, d), dtype, gen)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, causal=causal, sm_scale=sc, return_lse=True), q, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("group,d", [(1, 64), (2, 128), (4, 128), (8, 64)])
def test_decode_kernel_matches_plain(gen, dtype, group, d):
    B, hkv, ps, P = 5, 2, 16, 6
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), dtype, gen)
    pages = _randn((hkv, num_pages, 2 * ps, d), dtype, gen)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([0, 1, ps, P * ps, 1000], dtype=torch.int32,
                           device="cuda")
    before = fused_paged_decode_attention.launches
    for tab in (table, table[:, :3]):        # a column slice is a view
        out, lse = fused_paged_decode_attention(q, pages, lengths, tab,
                                                page_size=ps)
        torch.cuda.synchronize()
        ref, ref_lse = fused_paged_decode_plain(q, pages, lengths, tab,
                                                page_size=ps,
                                                sm_scale=d ** -0.5)
        assert _err(out, ref) <= tolerance_for(dtype)
        assert _err(lse, ref_lse) <= tolerance_for(dtype)
    assert fused_paged_decode_attention.launches == before + 2


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_decode_loop_never_syncs_with_the_host(gen, greedy):
    """A decode chunk queues its steps without one device-to-host wait,
    sampled steps included (the engine reads the tokens once at the end)."""
    from tiny_flash_attention_tpu_torch.models import transformer as T
    from tiny_flash_attention_tpu_torch.models.inference import decode_loop
    from tiny_flash_attention_tpu_torch.models.kv_cache import PagedKVCache

    cfg = T.ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
                        n_kv_heads=2, d_head=64, d_ff=256)
    params = T.init_params(cfg, gen, device="cuda")
    cache = PagedKVCache.create(n_layers=2, n_kv_heads=2, num_pages=9,
                                page_size=16, d_head=64, max_seqs=4,
                                pages_per_seq=2, dtype=cfg.dtype,
                                device="cuda")
    table = torch.arange(1, 9, dtype=torch.int32,
                         device="cuda").reshape(4, 2)
    tokens = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    positions = torch.tensor([0, 3, 7, 11], dtype=torch.int32, device="cuda")
    temps = torch.full((4,), 0.0 if greedy else 1.0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, sampled, _ = decode_loop(
            cfg, params, cache.pages, tokens, positions, table, temps, gen,
            page_size=16, fmt="bf16", n_steps=3, greedy=greedy)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sampled.shape == (3, 4)
    assert bool(((sampled >= 0) & (sampled < cfg.vocab_size)).all())


def test_not_ported_raises_on_the_card(gen):
    q = _randn((1, 2, 64, 64), torch.bfloat16, gen)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q.float(), q.float())     # mixed dtypes
    # head_dim above 256: the bf16 forward over bf16 K/V and the bf16
    # backward take it (up to 512), and so does the f32 forward; the f32
    # backward raises (queue B-dims-2a-f32-train); above 512 every entry
    # raises (B-dims-2a-512+)
    q264 = _randn((1, 2, 8, 264), torch.bfloat16, gen)
    lse = torch.zeros((1, 2, 8), device="cuda")
    assert flash_attention(q264, q264, q264).shape == q264.shape
    x = q264.float()
    assert flash_attention(x, x, x).shape == x.shape
    with pytest.raises(NotImplementedError, match="B-dims-2a-f32-train"):
        flash_attention_bwd(x, x, x, x, lse, x, causal=True)
    q520 = _randn((1, 2, 8, 520), torch.bfloat16, gen)
    for x in (q520, q520.float()):
        with pytest.raises(NotImplementedError, match="B-dims-2a-512"):
            flash_attention(x, x, x)
        with pytest.raises(NotImplementedError, match="B-dims-2a-512"):
            flash_attention_bwd(x, x, x, x, lse, x, causal=True)
    # head_dim above 256 in FA1 (its wide instances pad up to 256 and no
    # further; queue B-dims-2a-quant-v1)
    for x in (q264, q264.float(), q520):
        with pytest.raises(NotImplementedError):
            flash_attention_v1(x, x, x)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd(q, q.float(), q.float(), q,
                            torch.zeros((1, 2, 64), device="cuda"), q,
                            causal=True)
    # int8 K/V without their scales, the jagged mode over int8, one
    # quantized call over two payload formats, a head_dim above 256
    q8 = q.to(torch.int8)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q8, q8)
    with pytest.raises(NotImplementedError):
        flash_attention_rowloop(q, q8, q8, causal=True)
    k8 = Q.quantize_int8(q)
    with pytest.raises(NotImplementedError):
        flash_attention_quantized(q, k8, Q.quantize_fp8(q))
    k264 = Q.quantize_int8(q264)
    for x in (q264, q264.float()):
        with pytest.raises(NotImplementedError, match="B-dims-2a-quant-v1"):
            flash_attention_quantized(x, k264, k264)
    # the decodes and the append read pages in place at every head_dim up
    # to 512 (q in bf16 and f32) and raise above (queue B-dims-2a-512+);
    # int8 fused pages whose page size is neither <= head_dim nor a
    # multiple of it raise as JAX's assert does
    table = torch.arange(8, dtype=torch.int32, device="cuda").reshape(2, 4)
    lengths = torch.tensor([5, 20], dtype=torch.int32, device="cuda")
    rows2 = torch.zeros(2, dtype=torch.int32, device="cuda")
    qd = _randn((2, 6, 264), torch.float32, gen)
    pages_d = torch.zeros((2, 8, 32, 264), dtype=torch.float32,
                          device="cuda")
    assert fused_paged_decode_attention(qd, pages_d, lengths, table,
                                        page_size=16)[0].shape == qd.shape
    assert paged_decode_attention(qd, pages_d, pages_d, lengths,
                                  table)[0].shape == qd.shape
    for dtype, d in ((torch.bfloat16, 520), (torch.float32, 520)):
        qd = _randn((2, 6, d), dtype, gen)
        pages_d = torch.zeros((2, 8, 32, d), dtype=dtype, device="cuda")
        with pytest.raises(NotImplementedError):
            fused_paged_decode_attention(qd, pages_d, lengths, table,
                                         page_size=16)
        with pytest.raises(NotImplementedError):
            paged_decode_attention(qd, pages_d, pages_d, lengths, table)
        if d > 512:
            with pytest.raises(NotImplementedError):
                fused_page_append(pages_d, qd[:, :2], qd[:, :2], rows2,
                                  rows2, page_size=16)
    pages48 = torch.zeros((2, 8, 2 * 48 + 16, 36), dtype=torch.int8,
                          device="cuda")
    q36 = _randn((2, 6, 36), torch.bfloat16, gen)
    with pytest.raises(ValueError):
        fused_paged_decode_attention(q36, pages48, lengths, table,
                                     page_size=48)
    with pytest.raises(ValueError):
        fused_page_append(pages48, q36[:, :2], q36[:, :2], rows2, rows2,
                          page_size=48)


def _segment_ids(b, n, bounds, gen):
    """(b, n) int32 ids changing at `bounds` (off the 64-row tiles), a
    different shuffle of the ids per batch row."""
    ids = torch.zeros((b, n), dtype=torch.int32, device="cuda")
    for x in bounds:
        ids[:, x:] += 1
    return ids + torch.randint(0, 3, (b, 1), generator=gen, device="cuda",
                               dtype=torch.int32) * 10


@pytest.mark.parametrize("b,hq,hkv,n,d,causal,dtype,bounds", [
    (2, 8, 2, 300, 128, True, torch.bfloat16, (37, 100, 101, 250)),
    (1, 4, 2, 200, 64, False, torch.bfloat16, (65, 130)),
    (2, 4, 4, 130, 128, True, torch.float32, (1, 64, 127)),
    (1, 4, 2, 97, 64, False, torch.float32, (50,)),
])
def test_segment_kernel_matches_plain(gen, b, hq, hkv, n, d, causal, dtype,
                                      bounds):
    """Segment ids against the plain version; a q id that no kv column
    has gives an empty row; segment_starts prune without changing a bit."""
    q = _randn((b, hq, n, d), dtype, gen)
    k = _randn((b, hkv, n, d), dtype, gen)
    v = _randn((b, hkv, n, d), dtype, gen)
    seg = _segment_ids(b, n, bounds, gen)
    q_seg = seg.clone()
    q_seg[0, 3] = -7                          # matches no kv column
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal,
                               segment_ids=(q_seg, seg), return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, causal=causal, sm_scale=sc, segment_ids=(q_seg, seg),
        return_lse=True), q, dtype)
    assert bool((out[0, :, 3] == 0).all())
    pruned = flash_attention(q, k, v, causal=causal, segment_ids=(seg, seg),
                             segment_starts=(0, *bounds), return_lse=True)
    full = flash_attention(q, k, v, causal=causal, segment_ids=(seg, seg),
                           return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(pruned, full))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_rowloop_kernel_matches_plain(gen, dtype):
    """Jagged lengths around one 64-row tile; rows past a length are 0
    with the sentinel LSE. Without lengths: non-causal and a decode
    offset."""
    lens = torch.tensor([1, 63, 64, 65, 192], dtype=torch.int32,
                        device="cuda")
    q = _randn((5, 8, 192, 128), dtype, gen)
    k = _randn((5, 2, 192, 128), dtype, gen)
    v = _randn((5, 2, 192, 128), dtype, gen)
    before = flash_attention_rowloop.launches
    out, lse = flash_attention_rowloop(q, k, v, causal=True,
                                       seq_lengths=lens)
    torch.cuda.synchronize()
    assert flash_attention_rowloop.launches == before + 1
    ref, ref_lse = flash_attention_rowloop_plain(
        q, k, v, causal=True, sm_scale=128 ** -0.5, seq_lengths=lens)
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_rowloop_plain(
        x, k, v, causal=True, sm_scale=sc, seq_lengths=lens), q, dtype)
    for bi, L in enumerate(lens.tolist()):
        assert bool((out[bi, :, L:] == 0).all())
        torch.testing.assert_close(lse[bi, :, L:], ref_lse[bi, :, L:],
                                   rtol=1e-6, atol=0)   # the sentinel
    for q_len, causal in ((192, False), (40, True)):
        out, lse = flash_attention_rowloop(q[:, :, :q_len], k, v,
                                           causal=causal)
        _assert_flash_gate(
            out, lse, lambda x, sc, c=causal: flash_attention_rowloop_plain(
                x, k, v, causal=c, sm_scale=sc), q[:, :, :q_len], dtype)


def _forward_only_calls(gen):
    """{name: fn} for each CUDA entry whose JAX kernel has no VJP: fn(x)
    runs it on x, a leaf that requires grad, and returns a float output."""
    b16 = torch.bfloat16
    q4 = _randn((1, 4, 64, 64), b16, gen)
    ps, d = 16, 64
    pages = _randn((2, 4, 2 * ps, d), b16, gen)
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    lengths = torch.tensor([5, 20], dtype=torch.int32, device="cuda")
    kp = _randn((2, 4, ps, d), b16, gen)
    qw = Q.quantize_weight(_randn((64, 32), torch.float32, gen))
    k8, v8 = Q.quantize_kv(q4, q4, "int8")
    return {
        "flash_attention_quantized":
            lambda x: flash_attention_quantized(x, k8, v8, causal=True),
        "flash_attention(return_lse=True)":
            lambda x: flash_attention(x, q4, q4, causal=True,
                                      return_lse=True)[0],
        "flash_attention_rowloop":
            lambda x: flash_attention_rowloop(x, q4, q4, causal=True)[0],
        "flash_attention_v1": lambda x: flash_attention_v1(x, q4, q4),
        "fused_paged_decode_attention":
            lambda x: fused_paged_decode_attention(
                x[0, :, :2].transpose(0, 1), pages, lengths, table,
                page_size=ps)[0],
        "paged_decode_attention":
            lambda x: paged_decode_attention(
                x[0, :, :2].transpose(0, 1), kp, kp, lengths, table)[0],
        "quantized_matmul_cuda":
            lambda x: quantized_matmul_cuda(x[0, 0, :8], qw),
    }


@pytest.mark.parametrize("name", [
    "flash_attention(return_lse=True)", "flash_attention_quantized",
    "flash_attention_rowloop",
    "flash_attention_v1", "fused_paged_decode_attention",
    "paged_decode_attention", "quantized_matmul_cuda"])
def test_forward_only_entries_raise_at_backward(gen, name):
    """An entry whose JAX kernel has no VJP raises NotImplementedError at
    backward() rather than dropping the gradient; with grad off it runs
    without the Function."""
    fn = _forward_only_calls(gen)[name]
    x = _randn((1, 4, 64, 64), torch.bfloat16, gen).requires_grad_()
    out = fn(x)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="as in JAX"):
        out.float().sum().backward()
    with torch.no_grad():
        assert fn(x).grad_fn is None


@pytest.mark.parametrize("rows", [8, 16])
def test_quantized_matmul_gradient_matches_plain(gen, rows):
    """quantized_matmul is differentiable in x on either route (the kernel
    at 8 rows, the cuBLAS product at 16), as JAX's jnp.dot is."""
    qw = Q.quantize_weight(_randn((512, 256), torch.float32, gen))
    x = (_randn((rows, 512), torch.bfloat16, gen) / 512 ** 0.5)
    w = _randn((rows, 256), torch.float32, gen)
    leaf = x.clone().requires_grad_()
    (Q.quantized_matmul(leaf, qw).float() * w).sum().backward()
    ref = x.clone().requires_grad_()
    (quantized_matmul_plain(ref, qw).float() * w).sum().backward()
    assert leaf.grad.dtype == torch.bfloat16
    assert _err(leaf.grad, ref.grad) <= 2 ** -7 * float(
        ref.grad.float().abs().max())


# The backward kernels repeat their plain version's rounding points, so the
# two differ by the order of their f32 sums and, where that moves a result
# across a bf16 rounding boundary, by one bf16 ulp (at most 2^-7 of it). The
# gate is relative to the largest |gradient|: bf16 1e-2, f32 2e-5.
BWD_GATE = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,hq,hkv,q_len,kv_len,d,causal,dtype", [
    (1, 4, 4, 64, 64, 128, True, torch.bfloat16),      # group 1
    (2, 8, 2, 300, 300, 128, True, torch.bfloat16),    # group 4, ragged
    (1, 8, 1, 100, 260, 64, True, torch.bfloat16),     # group 8, offset
    (1, 4, 2, 200, 70, 128, True, torch.bfloat16),     # empty leading rows
    (1, 4, 2, 130, 97, 64, False, torch.bfloat16),
    (1, 2, 2, 1, 333, 128, True, torch.bfloat16),      # one decode row
    (1, 4, 4, 65, 65, 64, False, torch.float32),
    (1, 8, 2, 130, 130, 128, True, torch.float32),
    (1, 8, 1, 200, 70, 64, True, torch.float32),
    # the f32 kernels' work lists split ranges of more than 4 tiles
    (2, 4, 4, 333, 333, 128, True, torch.float32),     # group 1
    (1, 4, 2, 301, 301, 64, False, torch.float32),     # group 2
    (1, 8, 2, 97, 451, 128, True, torch.float32),      # group 4, offset
    (1, 8, 1, 517, 517, 128, True, torch.float32),     # group 8
])
def test_flash_bwd_kernels_match_plain(gen, b, hq, hkv, q_len, kv_len, d,
                                       causal, dtype):
    q = _randn((b, hq, q_len, d), dtype, gen)
    k = _randn((b, hkv, kv_len, d), dtype, gen)
    v = _randn((b, hkv, kv_len, d), dtype, gen)
    do = _randn((b, hq, q_len, d), dtype, gen)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                     sm_scale=d ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        err = _rel_err(g, w)
        assert err <= BWD_GATE[dtype], f"{name}: {err:.3e}"
    if causal and q_len > kv_len:        # rows that see nothing get dq = 0
        assert bool((got[0][:, :, :q_len - kv_len] == 0).all())


# (b, hq, hkv, q_len, kv_len, d, dtype, window, bounds, starts): odd
# lengths, groups 1, 2 and 4, head_dim 64 and 128, the window off the
# tiles, ids with and without static starts, a window with ids
MASKED_BWD = [
    (1, 4, 4, 97, 97, 64, torch.bfloat16, 30, None, False),
    (2, 4, 2, 300, 300, 128, torch.bfloat16, 100, None, False),
    (1, 8, 2, 130, 333, 128, torch.bfloat16, 64, None, False),   # offset
    (1, 8, 2, 300, 300, 128, torch.bfloat16, None, (37, 100, 250), False),
    (1, 8, 2, 300, 300, 128, torch.bfloat16, None, (37, 100, 250), True),
    (2, 4, 1, 130, 130, 64, torch.bfloat16, None, (1, 64, 127), True),
    (1, 4, 2, 300, 300, 64, torch.bfloat16, 70, (37, 200), True),
    (1, 4, 4, 97, 97, 64, torch.float32, 30, None, False),
    (1, 8, 2, 130, 130, 128, torch.float32, None, (50, 64), True),
    (1, 4, 2, 300, 300, 64, torch.float32, 70, (37, 200), True),
    # f32 at groups 1, 2, 4 and 8, odd lengths, every mask
    (2, 4, 4, 333, 333, 128, torch.float32, 150, None, False),
    (1, 4, 2, 401, 401, 128, torch.float32, None, (37, 100, 250), False),
    (1, 8, 2, 130, 451, 64, torch.float32, 90, None, False),     # offset
    (1, 8, 1, 517, 517, 128, torch.float32, None, (61, 300, 302), True),
    (2, 8, 1, 301, 301, 64, torch.float32, 200, (37, 200), True),
]


@pytest.mark.parametrize(
    "b,hq,hkv,q_len,kv_len,d,dtype,window,bounds,starts", MASKED_BWD)
def test_masked_bwd_kernels_match_plain(gen, b, hq, hkv, q_len, kv_len, d,
                                        dtype, window, bounds, starts):
    """The backward with the window, segment ids (a q id that matches no
    kv column: dq 0 on its row) and static segment_starts, against the
    plain version; the starts change no bit."""
    q = _randn((b, hq, q_len, d), dtype, gen)
    k = _randn((b, hkv, kv_len, d), dtype, gen)
    v = _randn((b, hkv, kv_len, d), dtype, gen)
    do = _randn((b, hq, q_len, d), dtype, gen)
    masks = {"window": window}
    if bounds is not None:
        seg = _segment_ids(b, q_len, bounds, gen)
        q_seg = seg.clone()
        if not starts:
            q_seg[0, 3] = -7
        masks["segment_ids"] = (q_seg, seg)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True,
                               **masks)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True, **masks)
    if starts:
        pruned = flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                     segment_starts=(0, *bounds), **masks)
        torch.cuda.synchronize()
        for g, w in zip(got, pruned):
            if dtype == torch.float32:
                assert torch.equal(g, w)
            else:   # the f32 sums arrive in another order: one ulp
                assert _err(g, w) <= 2 ** -7 * float(g.float().abs().max())
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                     sm_scale=d ** -0.5, **masks)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        err = _rel_err(g, w)
        assert err <= BWD_GATE[dtype], f"{name}: {err:.3e}"
    if bounds is not None and not starts:
        assert bool((got[0][0, :, 3] == 0).all())


def test_masked_autograd_matches_autograd_through_plain(gen):
    """flash_attention's Function with a window and ids on the card
    against torch autograd through the f32 plain forward."""
    seg = _segment_ids(1, 300, (37, 200), gen)
    leaves = [_randn(s, torch.bfloat16, gen).requires_grad_()
              for s in ((1, 8, 300, 128), (1, 2, 300, 128),
                        (1, 2, 300, 128))]
    w = _randn((1, 8, 300, 128), torch.float32, gen)
    masks = {"window": 90, "segment_ids": (seg, seg)}
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, causal=True, segment_starts=(37, 200),
                          **masks)
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    f32 = [t.detach().float().requires_grad_() for t in leaves]
    ref = flash_attention_plain(*f32, causal=True, sm_scale=128 ** -0.5,
                                **masks)
    want = torch.autograd.grad((ref * w).sum(), f32)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, r) <= 2e-2, name


def test_bwd_two_runs_agree_within_one_ulp(gen):
    """The bf16 backward adds its f32 partial sums into the accumulators
    in an order that changes from run to run: two runs agree within one
    bf16 ulp of each result."""
    q = _randn((2, 8, 1000, 128), torch.bfloat16, gen)
    k = _randn((2, 2, 1000, 128), torch.bfloat16, gen)
    v = _randn((2, 2, 1000, 128), torch.bfloat16, gen)
    do = _randn((2, 8, 1000, 128), torch.bfloat16, gen)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    one = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    two = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        a, b = a.float(), b.float()
        ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
        assert bool(((a - b).abs() <= ulp).all())


def test_autograd_runs_both_kernels(gen):
    q = _randn((2, 8, 256, 128), torch.bfloat16, gen).requires_grad_()
    k = _randn((2, 2, 256, 128), torch.bfloat16, gen).requires_grad_()
    v = _randn((2, 2, 256, 128), torch.bfloat16, gen).requires_grad_()
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("ps,d,group", [(64, 128, 4), (128, 128, 4),
                                        (256, 128, 2), (32, 64, 8),
                                        (128, 64, 1)])
def test_int8_decode_kernel_matches_plain(gen, dtype, ps, d, group):
    """int8 pages with scale rows (ps < d, ps == d, ps a multiple of d),
    lengths 0, 1, a page edge, the full table and past it."""
    B, hkv, P = 5, 2, 4
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), dtype, gen)
    pages = pack_paged_cache(_randn((hkv, num_pages, ps, d), dtype, gen),
                             _randn((hkv, num_pages, ps, d), dtype, gen),
                             "int8")
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([0, 1, ps, P * ps, 10**6], dtype=torch.int32,
                           device="cuda")
    before = fused_paged_decode_attention.int8_launches
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps)
    torch.cuda.synchronize()
    assert fused_paged_decode_attention.int8_launches == before + 1
    ref, ref_lse = fused_paged_decode_plain(q, pages, lengths, table,
                                            page_size=ps, sm_scale=d ** -0.5)
    assert _err(out, ref) <= tolerance_for(dtype)
    assert _err(lse, ref_lse) <= tolerance_for(dtype)
    assert bool((out[0] == 0).all())          # length 0: zeros


@pytest.mark.parametrize("src,fmt,ps,d", [
    (torch.bfloat16, "bf16", 128, 128), (torch.float32, "bf16", 16, 64),
    (torch.bfloat16, "int8", 64, 128), (torch.bfloat16, "int8", 128, 128),
    (torch.float32, "int8", 256, 128), (torch.bfloat16, "int8", 128, 64),
    # head_dim 80 and 96 (columns lane + 32 e), int8 scales in two groups
    (torch.bfloat16, "bf16", 128, 96), (torch.float32, "bf16", 16, 80),
    (torch.bfloat16, "int8", 64, 96), (torch.float32, "int8", 96, 96),
    (torch.bfloat16, "int8", 160, 80), (torch.bfloat16, "int8", 64, 80),
    # head_dim 256 (8 contiguous values a lane)
    (torch.bfloat16, "bf16", 128, 256), (torch.bfloat16, "bf16", 16, 256),
    (torch.bfloat16, "int8", 128, 256), (torch.bfloat16, "int8", 256, 256),
    (torch.float32, "int8", 64, 256), (torch.float32, "bf16", 128, 256),
    (torch.float32, "bf16", 16, 256), (torch.float32, "int8", 128, 256)])
def test_append_kernel_is_bit_exact(gen, src, fmt, ps, d):
    """The append kernel and its plain version run the same IEEE ops, so
    the pages agree bit for bit, an all-zero row (scale 1) included."""
    B, hkv, num_pages = 6, 2, 9
    pdtype = torch.int8 if fmt == "int8" else src
    pages = torch.randint(-100, 100, (hkv, num_pages, page_rows(ps, d, fmt),
                                      d), generator=gen, device="cuda"
                          ).to(pdtype)
    k_new = _randn((B, hkv, d), src, gen) * 3
    v_new = _randn((B, hkv, d), src, gen)
    k_new[2, 1] = 0.0
    ids = torch.tensor([1, 4, 8, 0, 3, 5], dtype=torch.int32, device="cuda")
    rows = torch.tensor([0, ps - 1, ps // 2, 1, 7 % ps, ps - 2],
                        dtype=torch.int32, device="cuda")
    want = page_append_plain(pages.clone(), k_new, v_new, ids, rows,
                             page_size=ps)
    before = fused_page_append.launches
    got = fused_page_append(pages, k_new, v_new, ids, rows, page_size=ps)
    torch.cuda.synchronize()
    assert got is pages and fused_page_append.launches == before + 1
    assert torch.equal(got.view(torch.uint8) if fmt == "int8" else got,
                       want.view(torch.uint8) if fmt == "int8" else want)


def _qmm_gate(want):
    if want.dtype == torch.float32:
        return tolerance_for(torch.float32)
    return 2.0 ** -7 * float(want.float().abs().max())


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("wfmt", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 256), (3, 1000, 40),
                                   (8, 4096, 1024), (16, 64, 8),
                                   (5, 1536, 264)])
def test_quant_matmul_kernel_matches_plain(gen, xdt, wfmt, m, k, n):
    """The kernel sums f32 products in another order than the plain
    version's f32 matmul: one rounding of x's dtype apart at most (bf16:
    an ulp is at most 2^-7 of the largest output; f32: the 2e-5 gate)."""
    x = _randn((m, k), xdt, gen) / k ** 0.5
    qw = Q.quantize_weight(_randn((k, n), torch.float32, gen), wfmt)
    before = quantized_matmul_cuda.launches
    got = quantized_matmul_cuda(x, qw)
    torch.cuda.synchronize()
    assert quantized_matmul_cuda.launches == before + 1
    want = quantized_matmul_plain(x, qw)
    assert got.dtype == xdt and got.shape == (m, n)
    assert _err(got, want) <= _qmm_gate(want)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_quant_matmul_k_splits_agree(gen, splits):
    """K split over the blocks of a cluster (ragged last slice at 3)."""
    x = _randn((8, 4000), torch.bfloat16, gen) / 4000 ** 0.5
    qw = Q.quantize_weight(_randn((4000, 264), torch.float32, gen))
    got = quantized_matmul_cuda(x, qw, splits=splits)
    torch.cuda.synchronize()
    want = quantized_matmul_plain(x, qw)
    assert _err(got, want) <= _qmm_gate(want)


def test_quantized_matmul_routes_by_rows(gen):
    """Decode rows take the kernel, prefill rows the cuBLAS product; both
    agree with the plain version."""
    from tiny_flash_attention_tpu_torch.ops.configs import (
        QUANT_MATMUL_MAX_ROWS)
    qw = Q.quantize_weight(_randn((512, 256), torch.float32, gen))
    for rows, launched in ((QUANT_MATMUL_MAX_ROWS, 1),
                           (QUANT_MATMUL_MAX_ROWS + 1, 0), (300, 0)):
        x = _randn((rows, 512), torch.bfloat16, gen) / 512 ** 0.5
        before = quantized_matmul_cuda.launches
        got = Q.quantized_matmul(x, qw)
        torch.cuda.synchronize()
        assert quantized_matmul_cuda.launches == before + launched
        want = quantized_matmul_plain(x, qw)
        assert _err(got, want) <= _qmm_gate(want)


@pytest.mark.parametrize("b,h,q_len,kv_len,d,causal,dtype", [
    (1, 2, 64, 64, 128, True, torch.bfloat16),
    (2, 3, 300, 260, 128, True, torch.bfloat16),      # padded kv
    (1, 2, 100, 333, 64, True, torch.bfloat16),       # the decode offset
    (1, 2, 300, 100, 128, True, torch.bfloat16),      # tiles no kv reaches
    (1, 2, 700, 700, 64, False, torch.bfloat16),
    (1, 2, 130, 130, 128, True, torch.float32),
    (1, 2, 200, 70, 64, True, torch.float32),
    (1, 2, 65, 97, 64, False, torch.float32),
    (1, 2, 1, 2100, 128, True, torch.bfloat16),       # one decode row
    (1, 2, 130, 2100, 64, True, torch.bfloat16),      # 130 decode rows
    (1, 2, 1000, 130, 128, True, torch.bfloat16),     # 6 tiles see nothing
    (2, 2, 1280, 1280, 128, True, torch.bfloat16),    # 5 blocks a head
    (1, 3, 1920, 1920, 64, False, torch.bfloat16),
    # f32 at the edges of its 64-row tiles, two q tiles a block
    (1, 2, 63, 63, 128, True, torch.float32),
    (1, 2, 64, 65, 64, True, torch.float32),          # the decode offset
    (2, 3, 129, 127, 128, True, torch.float32),       # rows before every kv
    (1, 2, 65, 64, 128, False, torch.float32),
    (1, 2, 257, 257, 128, False, torch.float32),
    (1, 2, 1, 333, 128, True, torch.float32),         # one decode row
    (1, 2, 1000, 130, 64, True, torch.float32),       # 13 tiles see nothing
    (2, 2, 1024, 1024, 128, True, torch.float32),     # 8 blocks a head
    (1, 3, 320, 320, 64, True, torch.float32),        # an odd tile count
    # head dims padded to 128
    (1, 3, 300, 260, 80, True, torch.bfloat16),
    (1, 3, 300, 260, 96, True, torch.bfloat16),
    (1, 3, 300, 260, 80, True, torch.float32),
    (1, 3, 300, 260, 96, False, torch.float32),
])
def test_v1_kernel_matches_plain(gen, b, h, q_len, kv_len, d, causal, dtype):
    """The FA1 kernel against its plain version at the dtype gate and, in
    bf16, at the gate of its q fold (row by row, the LSE at 1e-4); rows
    that see no column are 0 with the sentinel LSE in both."""
    q = _randn((b, h, q_len, d), dtype, gen)
    k = _randn((b, h, kv_len, d), dtype, gen)
    v = _randn((b, h, kv_len, d), dtype, gen)
    before = flash_attention_v1.launches
    out, lse = flash_attention_v1(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention_v1.launches == before + 1
    ref, ref_lse = flash_attention_v1_plain(q, k, v, causal=causal,
                                            sm_scale=d ** -0.5)
    atol = tolerance_for(dtype)
    assert _err(out, ref) <= atol and _err(lse, ref_lse) <= atol
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_v1_plain(
        x, k, v, causal=causal, sm_scale=sc), q, dtype)
    if causal and q_len > kv_len:
        assert bool((out[:, :, :q_len - kv_len] == 0).all())
        torch.testing.assert_close(lse[:, :, :q_len - kv_len],
                                   ref_lse[:, :, :q_len - kv_len],
                                   rtol=1e-6, atol=0)   # the sentinel


V1_EDGES = [127, 128, 129, 255, 257]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_len", V1_EDGES)
@pytest.mark.parametrize("q_len", V1_EDGES)
def test_v1_bf16_kernel_at_tile_edges(gen, q_len, kv_len, causal):
    """The bf16 FA1 kernel (128-row q and kv tiles) at lengths around its
    tile edges, at the row gate."""
    q = _randn((1, 2, q_len, 128), torch.bfloat16, gen)
    k = _randn((1, 2, kv_len, 128), torch.bfloat16, gen)
    v = _randn((1, 2, kv_len, 128), torch.bfloat16, gen)
    out, lse = flash_attention_v1(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_v1_plain(
        x, k, v, causal=causal, sm_scale=sc), q, torch.bfloat16)


def _v1_two_calls_agree(gen, dtype):
    q, k, v = (_randn((2, 4, 777, 128), dtype, gen) for _ in range(3))
    one = flash_attention_v1(q, k, v, causal=True, return_lse=True)
    two = flash_attention_v1(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_v1_bf16_kernel_runs_are_bit_identical(gen):
    """Each q tile's state goes to its own scratch slots and back by the
    same thread, in a fixed order: two calls give the same bits."""
    _v1_two_calls_agree(gen, torch.bfloat16)


def test_v1_f32_kernel_runs_are_bit_identical(gen):
    """The f32 instance: each step's p' comes from its S group in step
    order, and each PV thread stores and reloads its own state slots, so
    two calls give the same bits."""
    _v1_two_calls_agree(gen, torch.float32)


@pytest.mark.parametrize("fmt,group,d,ps", [
    ("bf16", 1, 64, 16), ("bf16", 4, 128, 128), ("bf16", 8, 64, 64),
    ("f32", 2, 128, 16), ("f32", 4, 64, 128),
    ("int8 bf16", 1, 64, 128), ("int8 bf16", 4, 128, 128),
    ("int8 bf16", 8, 128, 256), ("int8 f32", 2, 64, 128),
    ("int8 f32", 4, 128, 256),
    # head_dim 80 and 96, groups padded to 4 and 8 and two row blocks
    ("bf16", 3, 96, 128), ("int8 bf16", 3, 96, 128), ("bf16", 16, 80, 128),
    ("f32", 7, 80, 128),
    # head_dim 256, groups 1, 2, 8 (two row blocks of 4)
    ("bf16", 8, 256, 128), ("int8 bf16", 2, 256, 128), ("bf16", 1, 256, 16),
    ("int8 bf16", 8, 256, 256), ("f32", 8, 256, 128),
    ("int8 f32", 2, 256, 128), ("f32", 1, 256, 16),
    ("int8 f32", 8, 256, 256)])
def test_separate_decode_kernel_matches_plain(gen, fmt, group, d, ps):
    """Separate K/V page arrays (int8 pages with f32 scale pages, at page
    sizes that are multiples of 128 as JAX requires), lengths 0, 1, a page
    edge, the full table and past it, a column slice of the table."""
    B, hkv, P = 5, 2, 4
    num_pages = B * P + 3
    dtype = torch.float32 if fmt.endswith("f32") else torch.bfloat16
    q = _randn((B, hkv * group, d), dtype, gen)
    k = _randn((hkv, num_pages, ps, d), dtype, gen)
    v = _randn((hkv, num_pages, ps, d), dtype, gen)
    if fmt.startswith("int8"):
        k, v = Q.quantize_int8(k, axis=-1), Q.quantize_int8(v, axis=-1)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([0, 1, ps, P * ps, 10**6], dtype=torch.int32,
                           device="cuda")
    before = paged_decode_attention.launches
    for tab in (table, table[:, :3]):
        out, lse = paged_decode_attention(q, k, v, lengths, tab)
        torch.cuda.synchronize()
        ref, ref_lse = paged_decode_plain(q, k, v, lengths, tab,
                                          sm_scale=d ** -0.5)
        assert _err(out, ref) <= tolerance_for(dtype)
        assert _err(lse, ref_lse) <= tolerance_for(dtype)
        assert bool((out[0] == 0).all())
    assert paged_decode_attention.launches == before + 2


@pytest.mark.parametrize("b,hq,hkv,q_len,kv_len,d,window,dtype", [
    (1, 4, 2, 300, 300, 128, 1, torch.bfloat16),
    (2, 8, 2, 700, 700, 128, 100, torch.bfloat16),
    (1, 4, 2, 100, 333, 64, 64, torch.bfloat16),       # the decode offset
    (1, 4, 2, 200, 200, 128, 1000, torch.bfloat16),    # wider than the row
    (1, 2, 2, 1, 500, 128, 129, torch.bfloat16),       # one decode row
    (1, 4, 2, 130, 130, 128, 37, torch.float32),
    (1, 4, 2, 200, 70, 64, 20, torch.float32),         # empty leading rows
    (1, 8, 1, 333, 333, 64, 64, torch.float32),
])
def test_window_kernel_matches_plain(gen, b, hq, hkv, q_len, kv_len, d,
                                     window, dtype):
    """The window in the forward kernel (and the row loop's non-jagged
    entry) against the plain version; a window at least kv_len is plain
    causal."""
    q = _randn((b, hq, q_len, d), dtype, gen)
    k = _randn((b, hkv, kv_len, d), dtype, gen)
    v = _randn((b, hkv, kv_len, d), dtype, gen)
    before = flash_attention.window_launches
    out, lse = flash_attention(q, k, v, causal=True, window=window,
                               return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.window_launches == before + 1
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, window=window, return_lse=True),
        q, dtype)
    row = flash_attention_rowloop(q, k, v, causal=True, window=window)
    assert all(torch.equal(x, y) for x, y in zip(row, (out, lse)))
    if window >= kv_len:
        plain = flash_attention(q, k, v, causal=True, return_lse=True)
        assert all(torch.equal(x, y) for x, y in zip(plain, (out, lse)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_window_with_segments_kernel_matches_plain(gen, dtype):
    q = _randn((2, 8, 300, 128), dtype, gen)
    k = _randn((2, 2, 300, 128), dtype, gen)
    v = _randn((2, 2, 300, 128), dtype, gen)
    seg = _segment_ids(2, 300, (37, 100, 250), gen)
    out, lse = flash_attention(q, k, v, causal=True, window=50,
                               segment_ids=(seg, seg), return_lse=True)
    torch.cuda.synchronize()
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, window=50,
        segment_ids=(seg, seg), return_lse=True), q, dtype)
    pruned = flash_attention(q, k, v, causal=True, window=50,
                             segment_ids=(seg, seg),
                             segment_starts=(0, 37, 100, 250),
                             return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(pruned, (out, lse)))


@pytest.mark.parametrize("fmt", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("group,ps", [(1, 16), (4, 64)])
@pytest.mark.parametrize("window", [1, 35, "full"])
def test_ring_decode_kernel_matches_plain(gen, fmt, group, ps, window):
    """The ring mode over a random table: lengths 1, inside the table, past
    it once and three times; a window of 1, one across a page edge and the
    ring's whole capacity."""
    B, hkv, d, P = 5, 2, 128, 4
    num_pages = B * P + 3
    window = P * ps if window == "full" else window
    dtype = torch.float32 if fmt == "f32" else torch.bfloat16
    q = _randn((B, hkv * group, d), dtype, gen)
    pages = pack_paged_cache(_randn((hkv, num_pages, ps, d), dtype, gen),
                             _randn((hkv, num_pages, ps, d), dtype, gen),
                             "int8" if fmt == "int8" else "bf16")
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([1, 40, P * ps + 9, 3 * P * ps + 30, 1000],
                           dtype=torch.int32, device="cuda")
    before = fused_paged_decode_attention.ring_launches
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    assert fused_paged_decode_attention.ring_launches == before + 1
    ref, ref_lse = fused_paged_decode_plain(q, pages, lengths, table,
                                            page_size=ps, sm_scale=d ** -0.5,
                                            window=window)
    assert _err(out, ref) <= tolerance_for(dtype)
    assert _err(lse, ref_lse) <= tolerance_for(dtype)


@pytest.mark.parametrize("b,hq,hkv,q_len,kv_len,d,fmt,dtype,masks", [
    (1, 4, 4, 97, 97, 64, "int8", torch.bfloat16, {"causal": True}),
    (2, 8, 4, 130, 130, 128, "fp8", torch.bfloat16, {"causal": False}),
    (1, 8, 2, 300, 300, 128, "int8", torch.float32, {"causal": True}),
    (1, 4, 1, 97, 300, 64, "fp8", torch.float32, {"causal": True}),
    (1, 4, 2, 300, 130, 128, "int8", torch.bfloat16, {"causal": True}),
    (1, 2, 2, 1, 333, 128, "fp8", torch.bfloat16, {"causal": True}),
    (2, 8, 2, 300, 300, 128, "fp8", torch.bfloat16,
     {"causal": True, "window": 61}),
    (1, 4, 2, 130, 130, 64, "int8", torch.float32,
     {"causal": True, "window": 17}),
    (2, 8, 2, 300, 300, 128, "int8", torch.bfloat16,
     {"causal": True, "ids": (37, 100, 101, 250)}),
    (1, 4, 4, 130, 130, 64, "fp8", torch.float32,
     {"causal": False, "ids": (1, 64, 127)}),
    (1, 8, 2, 300, 300, 128, "fp8", torch.bfloat16,
     {"causal": True, "ids": (37, 100, 250), "starts": True}),
    (1, 4, 2, 97, 97, 64, "int8", torch.float32,
     {"causal": True, "ids": (50,), "starts": True, "window": 40}),
    # bf16 q at the edges of the 128-row tiles (odd kv lengths pad the
    # scale rows), rows before every kv position, the window and ids
    # across a tile edge, head_dim 64
    (1, 4, 2, 127, 127, 128, "int8", torch.bfloat16, {"causal": True}),
    (1, 4, 2, 128, 128, 128, "fp8", torch.bfloat16, {"causal": True}),
    (1, 4, 2, 129, 129, 64, "int8", torch.bfloat16, {"causal": False}),
    (2, 8, 2, 257, 257, 128, "fp8", torch.bfloat16, {"causal": True}),
    (1, 4, 2, 257, 129, 128, "int8", torch.bfloat16, {"causal": True}),
    (1, 4, 4, 129, 257, 64, "fp8", torch.bfloat16, {"causal": True}),
    (1, 8, 2, 257, 257, 128, "int8", torch.bfloat16,
     {"causal": True, "window": 129}),
    (1, 8, 2, 257, 257, 64, "fp8", torch.bfloat16,
     {"causal": True, "ids": (1, 127, 128, 129), "starts": True}),
], ids=["g1-d64", "g2-noncausal", "g4-f32", "offset-f32", "empty-rows",
        "decode-row", "window-bf16", "window-f32", "ids-bf16", "ids-f32",
        "starts-bf16", "starts-window-f32", "edge127", "edge128",
        "edge129-d64", "edge257", "q257-kv129", "q129-kv257-d64",
        "window129-257", "starts-edges-d64"])
def test_quantized_kernel_matches_plain(gen, b, hq, hkv, q_len, kv_len, d,
                                        fmt, dtype, masks):
    """The quantized instances against their plain version (out within the
    dtype gate of min(1, max|ref|)); each call counts one launch of its
    format; segment_starts prune without changing a bit; rows before every
    kv position are 0."""
    q = _randn((b, hq, q_len, d), dtype, gen)
    k, v = Q.quantize_kv(_randn((b, hkv, kv_len, d), torch.float32, gen),
                         _randn((b, hkv, kv_len, d), torch.float32, gen),
                         fmt)
    kw = {"causal": masks["causal"], "window": masks.get("window")}
    if "ids" in masks:
        seg = _segment_ids(b, q_len, masks["ids"], gen)
        kw["segment_ids"] = (seg, seg)
    per_fmt = "int8_launches" if fmt == "int8" else "fp8_launches"
    before = (flash_attention_quantized.launches,
              getattr(flash_attention_quantized, per_fmt))
    out, lse = flash_attention_quantized(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_quantized.launches,
            getattr(flash_attention_quantized, per_fmt)) == (
        before[0] + 1, before[1] + 1)
    ref, ref_lse = flash_attention_quantized_plain(
        q, k.values, v.values, k.scales, v.scales, sm_scale=d ** -0.5,
        return_lse=True, **kw)
    atol = tolerance_for(dtype)
    # out's gate scales with |out|, small where a row sees many columns
    ref_max = float(ref.float().abs().max())
    assert _err(out, ref) <= atol * min(1.0, ref_max)
    assert _err(lse, ref_lse) <= atol
    if kw["causal"] and q_len > kv_len:
        assert bool((out[:, :, :q_len - kv_len] == 0).all())
    if masks.get("starts"):
        pruned = flash_attention_quantized(
            q, k, v, return_lse=True, segment_starts=(0, *masks["ids"]),
            **kw)
        assert all(torch.equal(x, y) for x, y in zip(pruned, (out, lse)))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_kernel_runs_are_bit_identical(gen, fmt):
    """bf16 q over payloads: each tile's conversion and sums run in a fixed
    order, so two calls give the same bits."""
    q = _randn((2, 8, 777, 128), torch.bfloat16, gen)
    k, v = Q.quantize_kv(_randn((2, 2, 777, 128), torch.float32, gen),
                         _randn((2, 2, 777, 128), torch.float32, gen), fmt)
    one = flash_attention_quantized(q, k, v, causal=True, return_lse=True)
    two = flash_attention_quantized(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_quantized_kernel_maps_e4m3_codes_as_jax(gen, dtype):
    """K all zero (every column weighs the same) and V columns of one
    special e4m3 code each at scale 1: under bf16 q the kernel gives JAX's
    mapping (subnormal codes high, 0x7F/0xFF +/-480), under f32 q the exact
    value (NaN for the NaN codes), as its plain version does."""
    special = [0x01, 0x03, 0x07, 0x08, 0x7E, 0x7F, 0xFE, 0xFF]
    b, hq, n, d = 1, 2, 130, 64
    q = _randn((b, hq, n, d), dtype, gen)
    codes = torch.randint(0x08, 0x70, (b, 1, n, d), generator=gen,
                          device="cuda").to(torch.uint8)
    codes[..., :len(special)] = torch.tensor(special, dtype=torch.uint8,
                                             device="cuda")
    ones = torch.ones((b, 1, n, 1), device="cuda")
    k = Q.QuantizedTensor(torch.zeros_like(codes).view(torch.float8_e4m3fn),
                          ones)
    v = Q.QuantizedTensor(codes.view(torch.float8_e4m3fn), ones)
    out = flash_attention_quantized(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_quantized_plain(q, k.values, v.values, ones, ones,
                                          causal=False, sm_scale=d ** -0.5)
    cols = slice(0, len(special))
    torch.testing.assert_close(out[..., cols], ref[..., cols], rtol=0,
                               atol=0, equal_nan=True)
    assert _err(out[..., len(special):], ref[..., len(special):]) <= \
        tolerance_for(dtype)
    if dtype == torch.bfloat16:
        assert float(out[0, 0, 0, 5]) == 480.0
        assert float(out[0, 0, 0, 7]) == -480.0
    else:
        assert bool(torch.isnan(out[..., 5]).all())


# --- B1's bf16 kernel at its tile edges (128-row q and kv tiles, wgmma) ------

EDGES = [1, 127, 128, 129, 255, 257]


def _flash_vs_plain(gen, b, hq, hkv, q_len, kv_len, d, **kw):
    """One launch of B1 (bf16) against its plain version at the bf16 gates;
    returns the inputs and the kernel's (out, lse)."""
    q = _randn((b, hq, q_len, d), torch.bfloat16, gen)
    k = _randn((b, hkv, kv_len, d), torch.bfloat16, gen)
    v = _randn((b, hkv, kv_len, d), torch.bfloat16, gen)
    before = flash_attention.launches
    got = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_flash_gate(*got, lambda x, sc: flash_attention_plain(
        x, k, v, sm_scale=sc, return_lse=True, **kw), q, torch.bfloat16)
    assert bool(torch.isfinite(got[0]).all())
    return (q, k, v), got


def test_forward_smem_layouts_match_configs(gen):
    """ops/configs.py::fwd_smem_bytes gives the shared memory that each
    instance of the built forward libraries takes (their exported sizes)."""
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.ops.flash import check_smem_layouts
    for name, quantized in (("flash_fwd", False), ("flash_fwd_quant", True)):
        check_smem_layouts(_build.library(name), quantized)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_len", EDGES)
@pytest.mark.parametrize("q_len", EDGES)
def test_bf16_kernel_at_tile_edges(gen, q_len, kv_len, causal):
    """q_len and kv_len on each side of the 128-row tiles (one row, a tile
    but one, a tile, a tile and one, two tiles but one, two and one)."""
    _flash_vs_plain(gen, 1, 8, 2, q_len, kv_len, 128, causal=causal)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [129, 257])
def test_bf16_kernel_head_dims_and_groups(gen, n, d, group):
    _flash_vs_plain(gen, 2, 2 * group, 2, n, n, d, causal=True)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_len", [1, 130])
def test_bf16_kernel_decode_offset(gen, q_len, d):
    """q rows at the end of a kv of 2100: one row (the block's second
    warpgroup idle) and a tile and two rows."""
    _flash_vs_plain(gen, 2, 8, 2, q_len, 2100, d, causal=True)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [130, 128])
def test_bf16_kernel_window_edge_at_tile_edges(gen, window, d):
    """The window's left edge for the q tile at row 256 falls at column 127
    (window 130) and 129 (window 128), beside the 128-column tile edge; the
    row loop's non-jagged entry gives the same bits."""
    (q, k, v), got = _flash_vs_plain(gen, 1, 4, 2, 400, 400, d,
                                     causal=True, window=window)
    row = flash_attention_rowloop(q, k, v, causal=True, window=window)
    assert all(torch.equal(x, y) for x, y in zip(row, got))


@pytest.mark.parametrize("n", [300, 301], ids=["bulk-ids", "loaded-ids"])
def test_bf16_kernel_ids_across_the_tile_edge(gen, n):
    """Segment ids that change at 127, 128 and 129, causal and not, with kv
    lengths whose ids come by bulk copy (n % 4 == 0) and by the producer
    warp's loads; segment_starts prune without changing a bit."""
    bounds = (127, 128, 129, 250)
    seg = _segment_ids(2, n, bounds, gen)
    for causal in (True, False):
        (q, k, v), got = _flash_vs_plain(gen, 2, 8, 2, n, n, 128,
                                         causal=causal,
                                         segment_ids=(seg, seg))
        pruned = flash_attention(q, k, v, causal=causal,
                                 segment_ids=(seg, seg),
                                 segment_starts=(0, *bounds),
                                 return_lse=True)
        assert all(torch.equal(x, y) for x, y in zip(pruned, got))


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_rowloop_jagged_lengths_at_tile_edges(gen, d):
    """Jagged lengths 0, 1, 127, 128, 129 and the whole row: rows past a
    length are exactly 0 with the sentinel LSE."""
    lens = torch.tensor([0, 1, 127, 128, 129, 300], dtype=torch.int32,
                        device="cuda")
    q = _randn((6, 8, 300, d), torch.bfloat16, gen)
    k = _randn((6, 2, 300, d), torch.bfloat16, gen)
    v = _randn((6, 2, 300, d), torch.bfloat16, gen)
    before = flash_attention_rowloop.launches
    out, lse = flash_attention_rowloop(q, k, v, causal=True, seq_lengths=lens)
    torch.cuda.synchronize()
    assert flash_attention_rowloop.launches == before + 1
    ref, ref_lse = flash_attention_rowloop_plain(
        q, k, v, causal=True, sm_scale=d ** -0.5, seq_lengths=lens)
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_rowloop_plain(
        x, k, v, causal=True, sm_scale=sc, seq_lengths=lens), q,
        torch.bfloat16)
    for bi, L in enumerate(lens.tolist()):
        assert bool((out[bi, :, L:] == 0).all())
        torch.testing.assert_close(lse[bi, :, L:], ref_lse[bi, :, L:],
                                   rtol=1e-6, atol=0)   # the sentinel


# (hq, hkv, d, masks): groups 1, 4 and 8, head_dim 64, 96 and 192 (read in
# place), 128 and 256, causal, the window, segment ids, and ids with static
# segment_starts
DETERMINISM = [
    (4, 4, 128, "causal"), (8, 2, 128, "causal"), (8, 2, 64, "causal"),
    (4, 4, 64, "window"), (8, 2, 128, "window"), (8, 2, 128, "ids"),
    (4, 4, 128, "starts"), (8, 2, 64, "starts"),
    (8, 2, 96, "causal"), (4, 4, 96, "window"), (8, 2, 96, "ids"),
    (8, 1, 256, "causal"), (4, 4, 256, "window"), (8, 2, 256, "ids"),
    (8, 1, 256, "starts"), (8, 2, 192, "causal"), (4, 4, 192, "starts"),
    # the instance of width 512: both halves of a kv tile add into the dQ
    # chains of their own parts
    (8, 1, 512, "causal"), (8, 2, 512, "window"), (64, 1, 512, "ids"),
    (8, 1, 384, "starts"),
]


@pytest.mark.parametrize("hq,hkv,d,masks", DETERMINISM)
def test_bwd_runs_are_bit_identical(gen, hq, hkv, d, masks):
    """The bf16 backward sums in an order fixed by the shape and the masks
    (per-head dK, dV slots summed in head order; dQ added in each q tile's
    chain): three runs on the same inputs give the same bits."""
    b, n = 2, 1000
    q = _randn((b, hq, n, d), torch.bfloat16, gen)
    k = _randn((b, hkv, n, d), torch.bfloat16, gen)
    v = _randn((b, hkv, n, d), torch.bfloat16, gen)
    do = _randn((b, hq, n, d), torch.bfloat16, gen)
    kw, starts = {}, None
    if masks == "window":
        kw["window"] = 300
    if masks in ("ids", "starts"):
        seg = _segment_ids(b, n, (130, 480, 700), gen)
        kw["segment_ids"] = (seg, seg)
        if masks == "starts":
            starts = (0, 130, 480, 700)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, **kw)
    runs = [flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                segment_starts=starts, **kw)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for name, a, c in zip(("dq", "dk", "dv"), runs[0], other):
            assert torch.equal(a, c), name
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                     sm_scale=d ** -0.5, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), runs[0], want):
        assert _rel_err(g, w) <= BWD_GATE[torch.bfloat16], name


@pytest.mark.parametrize("hq,hkv,masks", [
    (4, 4, "causal"), (8, 2, "window"), (8, 1, "ids"), (4, 2, "starts")])
def test_f32_bwd_runs_are_bit_identical(gen, hq, hkv, masks):
    """The f32 backward sums in an order fixed by the shape and the masks
    (one slot per (work item, q head), summed by the post in range and
    head order): three runs on the same inputs give the same bits."""
    _f32_bwd_runs_agree(gen, hq, hkv, masks, 128)


def _f32_bwd_runs_agree(gen, hq, hkv, masks, d):
    """Three f32 backward runs at head_dim d on the same inputs (700 rows,
    causal, with `masks`) give the same bits, within the f32 gate of the
    plain version."""
    b, n = 1, 700
    q = _randn((b, hq, n, d), torch.float32, gen)
    k = _randn((b, hkv, n, d), torch.float32, gen)
    v = _randn((b, hkv, n, d), torch.float32, gen)
    do = _randn((b, hq, n, d), torch.float32, gen)
    kw, starts = {}, None
    if masks == "window":
        kw["window"] = 300
    if masks in ("ids", "starts"):
        seg = _segment_ids(b, n, (130, 480, 600), gen)
        kw["segment_ids"] = (seg, seg)
        if masks == "starts":
            starts = (0, 130, 480, 600)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, **kw)
    runs = [flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                segment_starts=starts, **kw)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for name, a, c in zip(("dq", "dk", "dv"), runs[0], other):
            assert torch.equal(a, c), name
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                     sm_scale=d ** -0.5, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), runs[0], want):
        assert _rel_err(g, w) <= BWD_GATE[torch.float32], name


@pytest.mark.parametrize("split", [1, 2, 3, 8])
def test_f32_bwd_splits_match_plain(gen, monkeypatch, split):
    """The f32 backward with the tiles' ranges cut into runs of 1 to 8
    tiles (ops/configs.py::FLASH_BWD_F32_SPLIT, read at each call), with a
    window and ids at group 4: each against the plain version, and the
    segment_starts pruning changes no bit."""
    monkeypatch.setattr(configs, "FLASH_BWD_F32_SPLIT", split)
    b, hq, hkv, n, d = 1, 8, 2, 611, 64
    q = _randn((b, hq, n, d), torch.float32, gen)
    k = _randn((b, hkv, n, d), torch.float32, gen)
    v = _randn((b, hkv, n, d), torch.float32, gen)
    do = _randn((b, hq, n, d), torch.float32, gen)
    seg = _segment_ids(b, n, (100, 333), gen)
    kw = {"window": 400, "segment_ids": (seg, seg)}
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True, **kw)
    pruned = flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                 segment_starts=(0, 100, 333), **kw)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                     sm_scale=d ** -0.5, **kw)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, pruned, want):
        assert torch.equal(g, p), name
        assert _rel_err(g, w) <= BWD_GATE[torch.float32], name


@pytest.mark.parametrize("hq,hkv,d,masks", DETERMINISM)
def test_bwd_chain_counters_end_at_zero(gen, hq, hkv, d, masks):
    """The last link of each q tile's dQ chain sets its counter back to 0:
    after a call, and after the main kernel alone runs again, every
    counter reads 0."""
    b, n = 2, 1000
    q = _randn((b, hq, n, d), torch.bfloat16, gen)
    k = _randn((b, hkv, n, d), torch.bfloat16, gen)
    v = _randn((b, hkv, n, d), torch.bfloat16, gen)
    do = _randn((b, hq, n, d), torch.bfloat16, gen)
    kw = {"window": 300} if masks == "window" else {}
    if masks in ("ids", "starts"):
        seg = _segment_ids(b, n, (130, 480, 700), gen)
        kw["segment_ids"] = (seg, seg)
        if masks == "starts":
            kw["segment_starts"] = (0, 130, 480, 700)
    fwd_kw = {key: val for key, val in kw.items() if key != "segment_starts"}
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True,
                               **fwd_kw)
    call = BwdLaunch(q, k, v, out, lse, do, causal=True, sm_scale=d ** -0.5,
                     config=configs.FlashConfig(), **kw)
    call.run()
    torch.cuda.synchronize()
    assert int(call.turns.abs().max()) == 0
    call.run(2)
    torch.cuda.synchronize()
    assert int(call.turns.abs().max()) == 0


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_matmul_converts_every_code_exactly(gen, fmt):
    """The bf16-x kernel's payload conversion (byte permutes for int8, the
    e4m3x2 convert for fp8) gives every one of the 256 codes exactly as
    the plain version's astype, in both halves of a converted pair; the
    e4m3 NaN codes stay NaN."""
    from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
        convert_codes)
    got = convert_codes(fmt, "cuda")
    torch.cuda.synchronize()
    codes = torch.arange(256, device="cuda").to(torch.uint8)
    want = codes.view(torch.int8 if fmt == "int8"
                      else torch.float8_e4m3fn).to(torch.bfloat16)
    nan = torch.isnan(want)
    assert int(nan.sum()) == (0 if fmt == "int8" else 2)
    for half in got:
        assert torch.equal(torch.isnan(half), nan)
        assert torch.equal(half[~nan].view(torch.int16),
                           want[~nan].view(torch.int16))


ENGINE_PROJECTIONS = [(1024, 1024), (1024, 256), (1024, 4096), (4096, 1024),
                      (1024, 32768)]


@pytest.mark.parametrize("wfmt", ["int8", "fp8"])
@pytest.mark.parametrize("k,n", ENGINE_PROJECTIONS)
def test_quant_matmul_engine_projections(gen, wfmt, k, n):
    """Every projection of the engine model (wq/wo, wk/wv, w_gate/w_up,
    w_down, the lm_head) at the kernel's rows 1 to 8, on its default K
    split, against the plain version."""
    qw = Q.quantize_weight(_randn((k, n), torch.float32, gen), wfmt)
    for m in range(1, 9):
        x = _randn((m, k), torch.bfloat16, gen)
        got = quantized_matmul_cuda(x, qw)
        torch.cuda.synchronize()
        want = quantized_matmul_plain(x, qw)
        assert _err(got, want) <= _qmm_gate(want), m


@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 5, 64])
def test_decode_splits_match_split_plain(gen, monkeypatch, fmt, ring,
                                         splits):
    """The split decode at several split counts (one split a page; 64 asks
    for more splits than pages), set through the split size in tokens,
    against the plain version over the same splits, at the decode gates
    (out 4e-3, LSE 1e-4, out row by row 2^-6 of the row's largest |out|),
    and against the unsplit plain version at the dtype gate: lengths 0, 1,
    a page edge, the full table and past it, or a ring that wrapped once
    and three times; splits past a sequence's length give empty
    partials."""
    B, hkv, group, d, ps, P = 5, 2, 4, 128, 32, 8
    num_pages = B * P + 3
    window = 100 if ring else None
    q = _randn((B, hkv * group, d), torch.bfloat16, gen)
    pages = pack_paged_cache(_randn((hkv, num_pages, ps, d), torch.bfloat16,
                                    gen),
                             _randn((hkv, num_pages, ps, d), torch.bfloat16,
                                    gen), fmt)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor(
        [1, 40, P * ps + 9, 3 * P * ps + 30, 150] if ring
        else [0, 1, ps, P * ps, 10**6], dtype=torch.int32, device="cuda")
    per, n = decode_splits(P, ps, window, splits)
    monkeypatch.setattr(configs, "PAGED_DECODE_SPLIT_TOKENS", per * ps)
    assert decode_splits(P, ps, window) == (per, n)
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    kw = dict(page_size=ps, sm_scale=d ** -0.5, window=window)
    ref, ref_lse = fused_paged_decode_plain(q, pages, lengths, table,
                                            splits=splits, **kw)
    assert _err(out, ref) <= 4e-3 and _err(lse, ref_lse) <= 1e-4
    assert row_err(out, ref) <= 2.0 ** -6
    whole, whole_lse = fused_paged_decode_plain(q, pages, lengths, table,
                                                **kw)
    assert _err(out, whole) <= tolerance_for(torch.bfloat16)
    assert _err(lse, whole_lse) <= tolerance_for(torch.bfloat16)
    if not ring:
        assert bool((out[0] == 0).all())


def test_decode_on_two_streams(gen):
    """Decodes of one shape on two streams at once each use their own
    cached workspace (partials and arrival counters) and agree with the
    plain version."""
    B, hkv, group, d, ps, P = 4, 2, 4, 128, 128, 16
    num_pages = B * P
    runs = []
    for _ in range(2):
        q = _randn((B, hkv * group, d), torch.bfloat16, gen)
        pages = pack_paged_cache(
            _randn((hkv, num_pages, ps, d), torch.bfloat16, gen),
            _randn((hkv, num_pages, ps, d), torch.bfloat16, gen), "int8")
        table = torch.randperm(num_pages, generator=gen, device="cuda")[
            :B * P].reshape(B, P).to(torch.int32)
        lengths = torch.full((B,), P * ps - 5, dtype=torch.int32,
                             device="cuda")
        runs.append((q, pages, lengths, table))
    streams = [torch.cuda.Stream() for _ in runs]
    torch.cuda.synchronize()
    outs = []
    for stream, (q, pages, lengths, table) in zip(streams, runs):
        with torch.cuda.stream(stream):
            outs.append([fused_paged_decode_attention(
                q, pages, lengths, table, page_size=ps) for _ in range(20)])
    torch.cuda.synchronize()
    for (q, pages, lengths, table), results in zip(runs, outs):
        ref, ref_lse = fused_paged_decode_plain(
            q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
            splits="kernel")
        for out, lse in results:
            assert row_err(out, ref) <= 2.0 ** -6
            assert _err(lse, ref_lse) <= 1e-4


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 3, 64])
def test_separate_decode_splits_match_split_plain(gen, monkeypatch, fmt,
                                                  splits):
    """B12 on the split template at several split counts (set through the
    split size in tokens), int8 pages with f32 scale pages included,
    against its split plain version."""
    B, hkv, group, d, ps, P = 5, 2, 4, 128, 128, 4
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), torch.bfloat16, gen)
    k = _randn((hkv, num_pages, ps, d), torch.bfloat16, gen)
    v = _randn((hkv, num_pages, ps, d), torch.bfloat16, gen)
    if fmt == "int8":
        k, v = Q.quantize_int8(k, axis=-1), Q.quantize_int8(v, axis=-1)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([0, 1, ps, 300, 10**6], dtype=torch.int32,
                           device="cuda")
    per, _ = decode_splits(P, ps, None, splits)
    monkeypatch.setattr(configs, "PAGED_DECODE_SPLIT_TOKENS", per * ps)
    out, lse = paged_decode_attention(q, k, v, lengths, table)
    torch.cuda.synchronize()
    ref, ref_lse = paged_decode_plain(q, k, v, lengths, table,
                                      sm_scale=d ** -0.5, splits=splits)
    assert _err(out, ref) <= 4e-3 and _err(lse, ref_lse) <= 1e-4
    assert row_err(out, ref) <= 2.0 ** -6
    assert bool((out[0] == 0).all())


# --- B1's f32 instance over kv runs, and the append after a writer ----------


def _f32_inputs(gen, hq, hkv, n, d, bounds=None):
    q = _randn((1, hq, n, d), torch.float32, gen)
    k = _randn((1, hkv, n, d), torch.float32, gen)
    v = _randn((1, hkv, n, d), torch.float32, gen)
    seg = None if bounds is None else _segment_ids(1, n, bounds, gen)
    return q, k, v, seg


@pytest.mark.parametrize("hq,hkv,masks", [
    (8, 8, "causal"), (8, 2, "window"), (8, 1, "ids"), (4, 2, "starts")])
def test_f32_fwd_runs_are_bit_identical(gen, hq, hkv, masks):
    """The f32 forward merges each q tile's runs in run order (the last run
    to arrive, in a fixed order): three calls give the same bits."""
    _f32_fwd_runs_agree(gen, hq, hkv, masks, 128)


def _f32_fwd_runs_agree(gen, hq, hkv, masks, d):
    """Three f32 forward calls at head_dim d on the same inputs (1100 rows,
    causal, with `masks`) give the same bits, within the f32 gate of the
    plain version."""
    q, k, v, seg = _f32_inputs(gen, hq, hkv, 1100, d,
                               (130, 480, 600) if masks in ("ids", "starts")
                               else None)
    kw = {"causal": True}
    if masks == "window":
        kw["window"] = 300
    if seg is not None:
        kw["segment_ids"] = (seg, seg)
    if masks == "starts":
        kw["segment_starts"] = (0, 130, 480, 600)
    runs = [flash_attention(q, k, v, return_lse=True, **kw)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(runs[0], other))
    kw.pop("segment_starts", None)
    _assert_flash_gate(*runs[0], lambda x, sc: flash_attention_plain(
        x, k, v, sm_scale=sc, return_lse=True, **kw), q, torch.float32)


@pytest.mark.parametrize("split", [1, 2, 3, 4, 16])
def test_f32_fwd_splits_match_plain(gen, split):
    """The f32 forward with each q tile's kv range cut into runs of 1 to
    16 tiles (a FlashConfig's `f32_split`), with a window and ids at group
    4 and with the decode offset: each against the plain version, and
    segment_starts' pruning changes no bit."""
    config = configs.FlashConfig(f32_split=split)
    q, k, v, seg = _f32_inputs(gen, 8, 2, 611, 64, (100, 333))
    kw = {"causal": True, "window": 400, "segment_ids": (seg, seg)}
    got = flash_attention(q, k, v, return_lse=True, config=config, **kw)
    pruned = flash_attention(q, k, v, return_lse=True, config=config,
                             segment_starts=(0, 100, 333), **kw)
    q1 = q[:, :, 400:]
    offset = flash_attention(q1, k, v, causal=True, return_lse=True,
                             config=config)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, pruned))
    _assert_flash_gate(*got, lambda x, sc: flash_attention_plain(
        x, k, v, sm_scale=sc, return_lse=True, **kw), q, torch.float32)
    _assert_flash_gate(*offset, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, return_lse=True), q1,
        torch.float32)


def _workspace_bytes():
    from tiny_flash_attention_tpu_torch.ops import flash as flash_mod

    return sum(t.numel() * t.element_size()
               for ws in flash_mod._fwd_workspaces.values() for t in ws)


@pytest.mark.parametrize("hq,hkv,q_len,kv_len,slots", [
    (8, 2, 8192, 8192, False), (2, 1, 4096, 32768, True)])
def test_f32_fwd_workspace_stays_bounded(gen, hq, hkv, q_len, kv_len,
                                         slots):
    """At long f32 lengths the merge's workspace stays within its bound
    (FLASH_FWD_F32_MAX_SLOTS slots of 128 x 130 f32): (1, 8, 8192) causal
    fills the card with its q tiles and takes no slot; a 4096-row chunk
    over a 32768-token cache splits at longer runs. Each against the plain
    version."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        fwd_f32_slots, fwd_f32_work)

    d = 128
    q = _randn((1, hq, q_len, d), torch.float32, gen)
    k, v = (_randn((1, hkv, kv_len, d), torch.float32, gen)
            for _ in range(2))
    before = _workspace_bytes()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    n_slots = fwd_f32_slots(*fwd_f32_work(q_len, kv_len, causal=True,
                                          n_bh=hq))[1]
    assert (n_slots > 0) == slots
    assert n_slots * hq <= configs.FLASH_FWD_F32_MAX_SLOTS
    bound = configs.FLASH_FWD_F32_MAX_SLOTS * 128 * (d + 2) * 4 + 4096
    assert _workspace_bytes() <= max(before, bound)
    if not slots:
        assert _workspace_bytes() == before
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, return_lse=True), q,
        torch.float32)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("q_len,kv_len", [(1, 1), (127, 127), (128, 128),
                                          (129, 129), (257, 63),
                                          (64, 257), (300, 300)])
def test_f32q_quantized_kernel_at_tile_edges(gen, fmt, q_len, kv_len):
    """f32 q over int8 and e4m3 payloads at the edges of the f32 body's
    128-row q tiles and 64-row kv tiles (rows before every column
    included), at runs of 2 kv tiles, so that the longer ranges split,
    against the plain version."""
    d = 128
    q = _randn((1, 8, q_len, d), torch.float32, gen)
    k, v = Q.quantize_kv(_randn((1, 2, kv_len, d), torch.float32, gen),
                         _randn((1, 2, kv_len, d), torch.float32, gen), fmt)
    out, lse = flash_attention_quantized(
        q, k, v, causal=True, config=configs.FlashConfig(f32_split=2),
        return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_quantized_plain(
        q, k.values, v.values, k.scales, v.scales, causal=True,
        sm_scale=d ** -0.5, return_lse=True)
    atol = tolerance_for(torch.float32)
    assert _err(out, ref) <= atol * min(1.0, float(ref.abs().max()))
    assert _err(lse, ref_lse) <= atol
    if q_len > kv_len:
        assert bool((out[:, :, :q_len - kv_len] == 0).all())


@pytest.mark.parametrize("fmt,src", [("bf16", torch.bfloat16),
                                     ("int8", torch.bfloat16),
                                     ("int8", torch.float32)])
def test_append_reads_what_the_kernel_before_it_wrote(gen, fmt, src):
    """1,000 appends, each launched right after a kernel that writes its
    k_new and v_new in place (a copy into the same tensors), each into rows
    of its own: the pages match the plain version's bit for bit, so no
    append read a row before its writer had written it."""
    steps, B, hkv, d, ps = 1000, 8, 2, 128, 16
    num_pages = steps * B // ps
    pdtype = torch.int8 if fmt == "int8" else src
    pages = torch.zeros((hkv, num_pages, page_rows(ps, d, fmt), d),
                        dtype=pdtype, device="cuda")
    ks = _randn((steps, B, hkv, d), src, gen)
    vs = _randn((steps, B, hkv, d), src, gen)
    k_new = torch.empty((B, hkv, d), dtype=src, device="cuda")
    v_new = torch.empty_like(k_new)
    slot = torch.arange(steps * B, dtype=torch.int32,
                        device="cuda").view(steps, B)
    ids, rows = slot // ps, slot % ps
    want = pages.clone()
    for i in range(steps):
        page_append_plain(want, ks[i], vs[i], ids[i], rows[i], page_size=ps)
    before = fused_page_append.launches
    for i in range(steps):
        k_new.copy_(ks[i])
        v_new.copy_(vs[i])
        fused_page_append(pages, k_new, v_new, ids[i], rows[i],
                          page_size=ps)
    torch.cuda.synchronize()
    assert fused_page_append.launches == before + steps
    assert torch.equal(pages.view(torch.uint8), want.view(torch.uint8))


# --- head dims and groups that no instance compiles --------------------------
# The flash kernels pad head_dim to 64 or 128 with zero columns; the decodes
# read rows of 80 and 96 in place and pad a kv head's q rows to 1, 2, 4, 8
# or row blocks of 8; the append writes rows of 80 and 96 (ops/dims.py).


def _ids(b, n, gen):
    return _segment_ids(b, n, (37, 100), gen)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("d,group,mask", [
    (72, 1, "causal"), (80, 3, "window"), (96, 7, "ids"), (96, 3, "causal"),
    (80, 7, "full"), (72, 3, "ids"), (96, 1, "window")])
def test_dims_flash_kernel_matches_plain(gen, dtype, d, group, mask):
    """B1 at head dims it pads (72: no multiple of 16) and groups 1, 3, 7,
    against the plain version at the true head_dim and its scale, at the
    dtype gate and (bf16) at the q fold; out comes back at the true
    head_dim."""
    b, hkv, n = 2, 2, 300
    q = _randn((b, hkv * group, n, d), dtype, gen)
    k = _randn((b, hkv, n, d), dtype, gen)
    v = _randn((b, hkv, n, d), dtype, gen)
    kw = {"causal": mask != "full"}
    if mask == "window":
        kw["window"] = 61
    if mask == "ids":
        seg = _ids(b, n, gen)
        kw["segment_ids"] = (seg, seg)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, sm_scale=sc, return_lse=True, **kw), q, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dims_quantized_kernel_matches_plain(gen, dtype, fmt):
    """The quantized forward at head_dim 96, group 3: payloads padded with
    code 0, scales unchanged."""
    q = _randn((1, 6, 130, 96), dtype, gen)
    kv = _randn((1, 2, 300, 96), dtype, gen)
    quant = Q.quantize_int8 if fmt == "int8" else Q.quantize_fp8
    kq, vq = quant(kv), quant(kv * 0.5)
    out, lse = flash_attention_quantized(q, kq, vq, causal=True,
                                         return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_quantized_plain(
        q, kq.values, vq.values, kq.scales, vq.scales, causal=True,
        sm_scale=96 ** -0.5, return_lse=True)
    assert out.shape == q.shape
    assert _err(out, ref) <= tolerance_for(dtype)
    assert _err(lse, ref_lse) <= tolerance_for(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("d,group,window", [(96, 3, None), (80, 7, 50),
                                            (72, 1, None)])
def test_dims_bwd_matches_plain(gen, dtype, d, group, window):
    """The backward at padded head dims, against its plain version at the
    true head_dim; gradients come back at the true head_dim, through
    flash_attention_bwd and through autograd."""
    b, hkv, n = 1, 2, 300
    q = _randn((b, hkv * group, n, d), dtype, gen)
    k = _randn((b, hkv, n, d), dtype, gen)
    v = _randn((b, hkv, n, d), dtype, gen)
    do = _randn((b, hkv * group, n, d), dtype, gen)
    out, lse = flash_attention(q, k, v, causal=True, window=window,
                               return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                              window=window)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                     sm_scale=d ** -0.5, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert _rel_err(g, w) <= BWD_GATE[dtype], name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, causal=True, window=window).backward(do)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        assert t.grad.shape == w.shape
        assert _rel_err(t.grad, w) <= BWD_GATE[dtype], name


DIMS_DECODE = [(fmt, d, group, ps)
               for fmt in ("bf16", "f32", "int8 bf16", "int8 f32")
               for d, group, ps in ((80, 3, 64), (96, 5, 32), (80, 7, 16),
                                    (96, 12, 64), (80, 16, 32))] + [
    # head_dim 256, q in either dtype over pages of q's dtype or int8 pages
    (fmt, 256, group, ps)
    for fmt in ("bf16", "int8 bf16", "f32", "int8 f32")
    for group, ps in ((1, 64), (2, 32), (8, 16), (12, 128), (3, 256))]


@pytest.mark.parametrize("fmt,d,group,ps", DIMS_DECODE)
def test_dims_decode_kernel_matches_plain(gen, fmt, d, group, ps):
    """The fused decode at head_dim 80 and 96 and groups 3, 5, 7, 12, 16
    over pages of q's dtype and int8 pages, lengths 0, 1, a page edge, the
    full table and past it, at the kernel's splits and unsplit, and the
    ring mode over a wrapped table."""
    B, hkv, P = 5, 2, 12
    num_pages = B * P + 3
    dtype = torch.float32 if fmt.endswith("f32") else torch.bfloat16
    q = _randn((B, hkv * group, d), dtype, gen)
    pages = pack_paged_cache(_randn((hkv, num_pages, ps, d), dtype, gen),
                             _randn((hkv, num_pages, ps, d), dtype, gen),
                             "int8" if fmt.startswith("int8") else "bf16")
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([0, 1, ps, P * ps, 10**6], dtype=torch.int32,
                           device="cuda")
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps)
    torch.cuda.synchronize()
    assert out.shape == q.shape and lse.shape == q.shape[:2]
    for splits in ("kernel", None):
        ref, ref_lse = fused_paged_decode_plain(
            q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
            splits=splits)
        assert _err(out, ref) <= tolerance_for(dtype)
        assert _err(lse, ref_lse) <= tolerance_for(dtype)
    assert bool((out[0] == 0).all())
    ring = torch.tensor([1, 40, P * ps + 9, 3 * P * ps + 30, 300],
                        dtype=torch.int32, device="cuda")
    out, lse = fused_paged_decode_attention(q, pages, ring, table,
                                            page_size=ps, window=100)
    torch.cuda.synchronize()
    ref, ref_lse = fused_paged_decode_plain(q, pages, ring, table,
                                            page_size=ps, sm_scale=d ** -0.5,
                                            window=100)
    assert _err(out, ref) <= tolerance_for(dtype)
    assert _err(lse, ref_lse) <= tolerance_for(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_dims_int8_decode_scale_rows_across_groups(gen, dtype):
    """int8 pages of 160 tokens at head_dim 80: a page's scales fill two
    groups of 80 columns, and the 32-token chunk at tokens 64-95 reads its
    scale bytes from both."""
    B, hkv, ps, P, d = 3, 2, 160, 3, 80
    num_pages = B * P + 2
    q = _randn((B, hkv * 3, d), dtype, gen)
    pages = pack_paged_cache(_randn((hkv, num_pages, ps, d), dtype, gen),
                             _randn((hkv, num_pages, ps, d), dtype, gen),
                             "int8")
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([96, 250, P * ps], dtype=torch.int32,
                           device="cuda")
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps)
    torch.cuda.synchronize()
    ref, ref_lse = fused_paged_decode_plain(q, pages, lengths, table,
                                            page_size=ps, sm_scale=d ** -0.5)
    assert _err(out, ref) <= tolerance_for(dtype)
    assert _err(lse, ref_lse) <= tolerance_for(dtype)


# --- head dims read in place -------------------------------------------------
# The bf16 forward over bf16 K/V and the bf16 backward read and write any
# head_dim that is a multiple of 8 at its true width (ops/dims.py::
# flash_head_dim): their results are the bits of the same call on tensors
# padded to the tiles' width by pad_head_dim, and the call makes no copy.

IN_PLACE = [(d, group, mask) for d in (32, 48, 72, 80, 96)
            for group in (1, 3, 7)
            for mask in ("causal", "window", "ids", "jagged")] + [
    # the wide instances (tiles of 256 columns) at 136 and 192
    (d, group, mask) for d in (136, 192) for group in (1, 4)
    for mask in ("causal", "window", "ids", "jagged")]


def _in_place_inputs(gen, d, group, mask, n=300):
    """q, k, v, do at head_dim d (n rows: not a multiple of either kernel's
    tile, so the last tile's masked rows are stored) and the mask's
    keywords (the jagged mode's lengths for "jagged")."""
    b, hkv = 2, 2
    q = _randn((b, hkv * group, n, d), torch.bfloat16, gen)
    k = _randn((b, hkv, n, d), torch.bfloat16, gen)
    v = _randn((b, hkv, n, d), torch.bfloat16, gen)
    do = _randn((b, hkv * group, n, d), torch.bfloat16, gen)
    kw = {}
    if mask == "window":
        kw["window"] = 61
    if mask == "ids":
        seg = _ids(b, n, gen)
        kw["segment_ids"] = (seg, seg)
    if mask == "jagged":
        kw["seq_lengths"] = torch.tensor([129, n], dtype=torch.int32,
                                         device="cuda")
    return (q, k, v, do), kw


def _padded(*ts):
    w = kernel_head_dim(ts[0].shape[-1], "the kernel", wide=True)
    return [pad_head_dim(t, w) for t in ts]


@pytest.mark.parametrize("d,group,mask", IN_PLACE)
def test_in_place_forward_is_the_padded_call(gen, d, group, mask):
    """B1 at a head_dim it reads in place: out and the LSE are the bits of
    the call on tensors padded to the tile's width (sliced back), and the
    call pads nothing."""
    (q, k, v, _), kw = _in_place_inputs(gen, d, group, mask)
    sc = d ** -0.5
    fn = flash_attention_rowloop if mask == "jagged" else flash_attention
    extra = {} if mask == "jagged" else {"return_lse": True}
    before, copies = fn.launches, pad_head_dim.copies
    out, lse = fn(q, k, v, causal=True, sm_scale=sc, **kw, **extra)
    torch.cuda.synchronize()
    assert pad_head_dim.copies == copies and fn.launches == before + 1
    assert out.shape == q.shape
    pout, plse = fn(*_padded(q, k, v), causal=True, sm_scale=sc, **kw,
                    **extra)
    assert torch.equal(out, unpad_head_dim(pout, d))
    assert torch.equal(lse, plse)


@pytest.mark.parametrize("d,group,mask", [
    x for x in IN_PLACE if x[2] != "jagged"])
def test_in_place_bwd_is_the_padded_call(gen, d, group, mask):
    """The bf16 backward at a head_dim it reads in place: dq, dk and dv are
    the bits of the call on tensors padded to the tile's width (sliced
    back), through flash_attention_bwd and through autograd, and neither
    pads."""
    (q, k, v, do), kw = _in_place_inputs(gen, d, group, mask)
    sc = d ** -0.5
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, **kw)
    copies = pad_head_dim.copies
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, causal=True, **kw).backward(do)
    torch.cuda.synchronize()
    assert pad_head_dim.copies == copies
    want = flash_attention_bwd(*_padded(q, k, v, out), lse, *_padded(do),
                               causal=True, sm_scale=sc, **kw)
    pl = [t.requires_grad_() for t in _padded(q, k, v)]
    flash_attention(*pl, causal=True, sm_scale=sc, **kw).backward(
        *_padded(do))
    for name, g, t, w, p in zip(("dq", "dk", "dv"), got, leaves, want, pl):
        assert g.shape == t.shape
        assert torch.equal(g, unpad_head_dim(w, d)), name
        assert torch.equal(t.grad, unpad_head_dim(p.grad, d)), name
        assert torch.equal(t.grad, g), name


@pytest.mark.parametrize("d", [72, 80, 88, 96])
def test_narrow_products_are_the_wide_instance(gen, d):
    """The instances of width 80 and 96 (products that skip the tiles' zero
    columns) give the bits of the 128-wide instance, forward and
    backward."""
    (q, k, v, do), kw = _in_place_inputs(gen, d, 3, "causal")
    calls = []
    for narrow in (True, False):
        config = configs.FlashConfig(narrow_products=narrow)
        out, lse = flash_attention(q, k, v, causal=True, config=config,
                                   return_lse=True)
        calls.append((out, lse, *flash_attention_bwd(
            q, k, v, out, lse, do, causal=True, config=config)))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *calls):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, "quantized"], ids=str)
def test_f32_and_quantized_forward_still_pad(gen, dtype):
    """The f32 instances and the quantized forward read tiles of 64 or 128
    columns: at head_dim 96 each call pads (three copies), and is right."""
    q = _randn((1, 6, 130, 96), torch.float32 if dtype == torch.float32
               else torch.bfloat16, gen)
    kv = _randn((1, 2, 130, 96), q.dtype, gen)
    copies = pad_head_dim.copies
    if dtype == "quantized":
        kq, vq = Q.quantize_int8(kv), Q.quantize_int8(kv * 0.5)
        out, _ = flash_attention_quantized(q, kq, vq, causal=True,
                                           return_lse=True)
        ref = flash_attention_quantized_plain(
            q, kq.values, vq.values, kq.scales, vq.scales, causal=True,
            sm_scale=96 ** -0.5)
    else:
        out = flash_attention(q, kv, kv, causal=True)
        ref = flash_attention_plain(q, kv, kv, causal=True,
                                    sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert pad_head_dim.copies == copies + 3
    assert _err(out, ref) <= tolerance_for(q.dtype)


# --- head_dim 256: the wide instances ----------------------------------------
# B1 over 64-row kv tiles in two stages (K and V slots released apart), the
# backward's wide main kernel (64-row kv blocks, the head dims split between
# the warpgroups), the decodes and the append at 256 (ops/dims.py).


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "full",
                                  "offset"])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("d", [192, 256])
def test_wide_flash_kernel_matches_plain(gen, d, group, mask):
    """B1's wide instance against its plain version at the bf16 gates: 300
    rows (not a multiple of the 64-row kv tiles), each mask, the decode
    offset (130 q rows over 300 kv rows)."""
    kw = {"causal": mask != "full"}
    q_len = 130 if mask == "offset" else 300
    if mask == "window":
        kw["window"] = 61
    if mask == "ids":
        seg = _ids(2, 300, gen)
        kw["segment_ids"] = (seg, seg)
    hkv = 2 if group < 8 else 1
    _flash_vs_plain(gen, 2, hkv * group, hkv, q_len, 300, d, **kw)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_len", [1, 63, 64, 65, 129, 257])
@pytest.mark.parametrize("q_len", [1, 127, 129, 257])
def test_wide_kernel_at_tile_edges(gen, q_len, kv_len, causal):
    """q_len on each side of the 128-row q tiles and kv_len on each side of
    the wide instance's 64-row kv tiles (one, a ring stage's worth, two
    stages and one)."""
    _flash_vs_plain(gen, 1, 8, 1, q_len, kv_len, 256, causal=causal)


def test_wide_kernel_ids_with_segment_starts(gen):
    """segment_starts prune each q tile's range on the wide instance's own
    table (64-row kv tiles): the same bits as without them."""
    b, n = 1, 1000
    q = _randn((b, 8, n, 256), torch.bfloat16, gen)
    k = _randn((b, 1, n, 256), torch.bfloat16, gen)
    v = _randn((b, 1, n, 256), torch.bfloat16, gen)
    seg = torch.zeros((b, n), dtype=torch.int32, device="cuda")
    for x in (130, 480, 700):
        seg[:, x:] += 1
    got = flash_attention(q, k, v, causal=True, segment_ids=(seg, seg),
                          segment_starts=(0, 130, 480, 700), return_lse=True)
    want = flash_attention(q, k, v, causal=True, segment_ids=(seg, seg),
                           return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    _assert_flash_gate(*got, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, segment_ids=(seg, seg),
        return_lse=True), q, torch.bfloat16)


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "starts",
                                  "full"])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("d", [192, 256])
def test_wide_bwd_matches_plain(gen, d, group, mask):
    """The wide backward against its plain version at the bf16 gate, each
    mask, 1000 rows (not a multiple of the 64-row tiles) over 900 kv rows
    where causal is off; through flash_attention_bwd and autograd."""
    b, hkv = 2, 2 if group == 1 else 1
    q_len, kv_len = (1000, 900) if mask == "full" else (1000, 1000)
    q = _randn((b, hkv * group, q_len, d), torch.bfloat16, gen)
    k = _randn((b, hkv, kv_len, d), torch.bfloat16, gen)
    v = _randn((b, hkv, kv_len, d), torch.bfloat16, gen)
    do = _randn((b, hkv * group, q_len, d), torch.bfloat16, gen)
    kw, starts = {"causal": mask != "full"}, None
    if mask == "window":
        kw["window"] = 300
    if mask in ("ids", "starts"):
        seg = _segment_ids(b, q_len, (130, 480, 700), gen)
        kw["segment_ids"] = (seg, seg)
        if mask == "starts":
            starts = (0, 130, 480, 700)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, segment_starts=starts,
                              **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                     sm_scale=d ** -0.5, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= BWD_GATE[torch.bfloat16], name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, segment_starts=starts, **kw).backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), leaves, got):
        assert torch.equal(t.grad, g), name


@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("group", [8, 12])
def test_wide_decode_row_blocks_match_plain(gen, group, fmt, ring):
    """Groups of 8 and 12 at head_dim 256, as two and three row blocks of
    G = 4 over the same pages, over bf16 and int8 pages, in plain and ring
    mode, against the plain version."""
    B, hkv, ps, P, d = 4, 1, 64, 6, 256
    num_pages = B * P + 3
    q = _randn((B, group, d), torch.bfloat16, gen)
    pages = pack_paged_cache(
        _randn((hkv, num_pages, ps, d), torch.bfloat16, gen),
        _randn((hkv, num_pages, ps, d), torch.bfloat16, gen), fmt)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([1, ps, P * ps - 5, 3 * P * ps + 30 if ring
                            else P * ps], dtype=torch.int32, device="cuda")
    window = 200 if ring else None
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    ref, ref_lse = fused_paged_decode_plain(
        q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
        window=window, splits="kernel")
    assert _err(out, ref) <= tolerance_for(torch.bfloat16)
    assert _err(lse, ref_lse) <= 1e-4


def test_wide_smem_layouts_match_configs(gen):
    """ops/configs.py::bwd_smem_bytes gives the shared memory of each bf16
    backward main kernel, the wide one and that of width 512 included (the
    library's sizes)."""
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import check_bf16_smem
    check_bf16_smem(_build.library("flash_bwd"))


# --- head dims 257-512: the instances of width 512 ----------------------------
# B1 in bf16 over bf16 K/V (64 q rows both consumers take, each one
# 256-column half of O; 32-row kv tiles), the decodes over bf16 and int8
# pages (blocks of three warps, groups as row blocks of DECODE_TOP_512) and
# the append (ops/dims.py).


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "full",
                                  "offset"])
@pytest.mark.parametrize("group", [1, 8, 64])
@pytest.mark.parametrize("d", [264, 384, 512])
def test_wider_flash_kernel_matches_plain(gen, d, group, mask):
    """B1's instance of width 512 against its plain version at the bf16
    gates: 300 rows (not a multiple of the 64-row q or 32-row kv tiles),
    each mask, the decode offset (130 q rows over 300 kv rows), two
    sequences; a group of 64 is DeepSeek-V4-Flash's."""
    kw = {"causal": mask != "full"}
    q_len = 130 if mask == "offset" else 300
    b = 2
    if mask == "window":
        kw["window"] = 61
    if mask == "ids":
        seg = _ids(b, 300, gen)
        kw["segment_ids"] = (seg, seg)
    hkv = 2 if group == 1 else 1
    _flash_vs_plain(gen, b, hkv * group, hkv, q_len, 300, d, **kw)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 65, 257])
@pytest.mark.parametrize("q_len", [1, 63, 65, 257])
def test_wider_kernel_at_tile_edges(gen, q_len, kv_len, causal):
    """q_len on each side of the 64-row q tiles and kv_len on each side of
    the 32-row kv tiles (one, a ring stage's worth, two stages and one)."""
    _flash_vs_plain(gen, 1, 8, 1, q_len, kv_len, 512, causal=causal)


@pytest.mark.parametrize("d", [264, 392, 448, 512])
def test_wider_in_place_is_the_padded_call(gen, d):
    """B1 at a head_dim in (256, 512] read in place: out and the LSE are
    the bits of the call on tensors padded to 512 (sliced back), under ids
    with segment_starts (their table at the instance's own tiles), and in
    the jagged mode; the in-place calls pad nothing (at 512 the padded
    call is the same call)."""
    b, n = 2, 700
    q = _randn((b, 8, n, d), torch.bfloat16, gen)
    k = _randn((b, 1, n, d), torch.bfloat16, gen)
    v = _randn((b, 1, n, d), torch.bfloat16, gen)
    seg = _segment_ids(b, n, (130, 480), gen)
    kw = {"causal": True, "segment_ids": (seg, seg), "sm_scale": d ** -0.5}
    copies = pad_head_dim.copies
    got = flash_attention(q, k, v, return_lse=True,
                          segment_starts=(0, 130, 480), **kw)
    lens = torch.tensor([129, n], dtype=torch.int32, device="cuda")
    jag = flash_attention_rowloop(q, k, v, causal=True, sm_scale=d ** -0.5,
                                  seq_lengths=lens)
    torch.cuda.synchronize()
    assert pad_head_dim.copies == copies
    padded = [pad_head_dim(t, 512) for t in (q, k, v)]
    want = flash_attention(*padded, return_lse=True, **kw)
    want_jag = flash_attention_rowloop(*padded, causal=True,
                                       sm_scale=d ** -0.5, seq_lengths=lens)
    for a, c in ((got, want), (jag, want_jag)):
        assert torch.equal(a[0], unpad_head_dim(c[0], d))
        assert torch.equal(a[1], c[1])
    _assert_flash_gate(*got, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, segment_ids=(seg, seg),
        return_lse=True), q, torch.bfloat16)


def test_wider_backward_raises(gen):
    """The bf16 backward stops at 512: at 520 it raises, naming queue
    B-dims-2a-512+, and in f32 it stops at 256 (B-dims-2a-f32-train),
    though the f32 forward runs there: a backward() through B1 in f32 at
    384 raises at backward(), naming the queue and the true head_dim 384
    (not the 512 its saved tensors are padded to), never dropping the
    gradient, while one in bf16 at 384 runs."""
    lse = torch.zeros((1, 2, 64), device="cuda")
    x = _randn((1, 2, 64, 520), torch.bfloat16, gen)
    with pytest.raises(NotImplementedError, match="B-dims-2a-512"):
        flash_attention_bwd(x, x, x, x, lse, x, causal=True)
    x = _randn((1, 2, 64, 264), torch.float32, gen)
    with pytest.raises(NotImplementedError, match="B-dims-2a-f32-train"):
        flash_attention_bwd(x, x, x, x, lse, x, causal=True)
    x = _randn((1, 2, 64, 384), torch.float32, gen).requires_grad_()
    out = flash_attention(x, x, x, causal=True)
    assert out.shape == x.shape
    with pytest.raises(NotImplementedError,
                       match="head_dim 384.*B-dims-2a-f32-train"):
        out.sum().backward()
    assert x.grad is None
    x = _randn((1, 2, 64, 384), torch.bfloat16, gen).requires_grad_()
    flash_attention(x, x, x, causal=True).float().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "starts",
                                  "full"])
@pytest.mark.parametrize("group", [1, 8, 64])
@pytest.mark.parametrize("d", [264, 384, 512])
def test_wider_bwd_matches_plain(gen, d, group, mask):
    """The backward's instance of width 512 against its plain version at
    the bf16 gate, each mask, 300 rows (not a multiple of the 32-row q
    steps or the 64-row kv tiles) over 250 kv rows where causal is off; a
    group of 64 is DeepSeek-V4-Flash's; through flash_attention_bwd and
    autograd."""
    b, hkv = 2, 2 if group == 1 else 1
    q_len, kv_len = (300, 250) if mask == "full" else (300, 300)
    q = _randn((b, hkv * group, q_len, d), torch.bfloat16, gen)
    k = _randn((b, hkv, kv_len, d), torch.bfloat16, gen)
    v = _randn((b, hkv, kv_len, d), torch.bfloat16, gen)
    do = _randn((b, hkv * group, q_len, d), torch.bfloat16, gen)
    kw, starts = {"causal": mask != "full"}, None
    if mask == "window":
        kw["window"] = 61
    if mask in ("ids", "starts"):
        seg = _segment_ids(b, q_len, (70, 130, 230), gen)
        kw["segment_ids"] = (seg, seg)
        if mask == "starts":
            starts = (0, 70, 130, 230)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, segment_starts=starts,
                              **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                     sm_scale=d ** -0.5, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= BWD_GATE[torch.bfloat16], name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, segment_starts=starts, **kw).backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), leaves, got):
        assert torch.equal(t.grad, g), name


@pytest.mark.parametrize("d", [264, 392, 448])
def test_wider_in_place_bwd_is_the_padded_call(gen, d):
    """The backward at a head_dim in (256, 512] read in place: dq, dk and
    dv are the bits of the call on tensors padded to 512 (sliced back),
    through flash_attention_bwd and through autograd, and neither pads."""
    b, n = 2, 300
    q = _randn((b, 8, n, d), torch.bfloat16, gen)
    k = _randn((b, 1, n, d), torch.bfloat16, gen)
    v = _randn((b, 1, n, d), torch.bfloat16, gen)
    do = _randn((b, 8, n, d), torch.bfloat16, gen)
    seg = _segment_ids(b, n, (70, 230), gen)
    kw = {"causal": True, "segment_ids": (seg, seg), "sm_scale": d ** -0.5}
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    copies = pad_head_dim.copies
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, **kw).backward(do)
    torch.cuda.synchronize()
    assert pad_head_dim.copies == copies
    want = flash_attention_bwd(*(pad_head_dim(t, 512) for t in (q, k, v, out)),
                               lse, pad_head_dim(do, 512), **kw)
    for name, g, t, w in zip(("dq", "dk", "dv"), got, leaves, want):
        assert torch.equal(g, unpad_head_dim(w, d)), name
        assert torch.equal(t.grad, g), name



@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("d,ps,group", [(512, 64, 1), (512, 128, 64),
                                        (512, 48, 8), (384, 64, 2),
                                        (300, 1, 8), (448, 32, 64)])
def test_wider_decode_matches_plain(gen, d, ps, group, fmt, ring):
    """B4 at head dims 300-512 (compiled at 512 with page size 16 or a
    multiple of 32, at run time otherwise), groups as row blocks of
    DECODE_TOP_512 q rows over the same pages, over bf16 and int8 pages,
    in plain and ring mode, against the plain version at the kernel's
    splits; the run-time width instances count their launches."""
    B, hkv = 4, 1
    P = -(-600 // ps)
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), torch.bfloat16, gen)
    pages = pack_paged_cache(
        _randn((hkv, num_pages, ps, d), torch.bfloat16, gen),
        _randn((hkv, num_pages, ps, d), torch.bfloat16, gen), fmt)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([1, ps, P * ps - 5, 3 * P * ps + 30 if ring
                            else P * ps], dtype=torch.int32, device="cuda")
    window = min(200, P * ps) if ring else None
    widths = fused_paged_decode_attention.width_launches
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    assert fused_paged_decode_attention.width_launches == widths + (
        not decode_compiled(d, ps))
    ref, ref_lse = fused_paged_decode_plain(
        q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
        window=window, splits="kernel")
    assert _err(out, ref) <= tolerance_for(torch.bfloat16)
    assert _err(lse, ref_lse) <= 1e-4


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("d,ps,group", [(512, 128, 64), (384, 48, 8),
                                        (300, 128, 1)])
def test_wider_separate_decode_matches_plain(gen, d, ps, group, fmt):
    """B12 at head dims 300-512 over bf16 pages and int8 pages with f32
    scales (int8 at a multiple of 128), against the plain version at the
    kernel's splits."""
    if fmt == "int8" and ps % 128:
        ps = 128
    B, hkv, P = 4, 1, -(-600 // ps)
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), torch.bfloat16, gen)
    k, v = (_randn((hkv, num_pages, ps, d), torch.bfloat16, gen)
            for _ in range(2))
    if fmt == "int8":
        k, v = Q.quantize_int8(k, axis=-1), Q.quantize_int8(v, axis=-1)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([1, ps + 3, P * ps - 5, P * ps],
                           dtype=torch.int32, device="cuda")
    out, lse = paged_decode_attention(q, k, v, lengths, table)
    torch.cuda.synchronize()
    ref, ref_lse = paged_decode_plain(q, k, v, lengths, table,
                                      sm_scale=d ** -0.5, splits="kernel")
    assert _err(out, ref) <= tolerance_for(torch.bfloat16)
    assert _err(lse, ref_lse) <= 1e-4


@pytest.mark.parametrize("fmt,dtype", [("bf16", torch.bfloat16),
                                       ("bf16", torch.float32),
                                       ("int8", torch.bfloat16)])
@pytest.mark.parametrize("d,ps", [(512, 64), (512, 1024), (300, 48),
                                  (384, 1), (511, 128)])
def test_wider_append_matches_plain(gen, d, ps, fmt, dtype):
    """B5 at head dims 300-512 (512 on its own instance, the others on the
    run-time one of 16 values a lane) into bf16, f32 and int8 pages, bit
    for bit against the scatter decomposition."""
    hkv, batch, npages = 2, 5, 12
    shape = (hkv, npages, page_rows(ps, d, fmt), d)
    pages = (torch.randint(-127, 128, shape, generator=gen, device="cuda")
             .to(torch.int8) if fmt == "int8" else _randn(shape, dtype, gen))
    k_new = _randn((batch, hkv, d), dtype, gen) * 3
    v_new = _randn((batch, hkv, d), dtype, gen)
    ids = torch.randperm(npages, generator=gen, device="cuda")[:batch].to(
        torch.int32)
    rows = torch.randint(0, ps, (batch,), generator=gen, device="cuda").to(
        torch.int32)
    want = page_append_plain(pages.clone(), k_new, v_new, ids, rows,
                             page_size=ps)
    got = fused_page_append(pages, k_new, v_new, ids, rows, page_size=ps)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


# --- head_dim 256 in f32: the wide f32 instances -----------------------------
# B1's f32 body over 64-row q and 32-row kv tiles, the f32 backward over
# 32-row tiles, the decodes over f32 pages on blocks of fewer warps, the
# append into f32 pages (ops/dims.py: f32 takes (128, 256], padded to 256).


def _f32_vs_plain(gen, b, hq, hkv, q_len, kv_len, d, **kw):
    """One launch of B1 in f32 against its plain version at the f32 gate;
    returns the inputs and the kernel's (out, lse)."""
    q = _randn((b, hq, q_len, d), torch.float32, gen)
    k = _randn((b, hkv, kv_len, d), torch.float32, gen)
    v = _randn((b, hkv, kv_len, d), torch.float32, gen)
    before = flash_attention.launches
    got = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_flash_gate(*got, lambda x, sc: flash_attention_plain(
        x, k, v, sm_scale=sc, return_lse=True, **kw), q, torch.float32)
    return (q, k, v), got


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "full",
                                  "offset"])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("d", [192, 256])
def test_wide_f32_flash_kernel_matches_plain(gen, d, group, mask):
    """B1's wide f32 instance against its plain version at the f32 gate:
    300 rows (not a multiple of its 64-row q or 32-row kv tiles), each
    mask, the decode offset (130 q rows over 300 kv rows); at 192 through
    the padded route."""
    kw = {"causal": mask != "full"}
    q_len = 130 if mask == "offset" else 300
    if mask == "window":
        kw["window"] = 61
    if mask == "ids":
        seg = _ids(2, 300, gen)
        kw["segment_ids"] = (seg, seg)
    hkv = 2 if group < 8 else 1
    copies = pad_head_dim.copies
    _f32_vs_plain(gen, 2, hkv * group, hkv, q_len, 300, d, **kw)
    assert pad_head_dim.copies == copies + (3 if d != 256 else 0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 65, 257])
@pytest.mark.parametrize("q_len", [1, 63, 64, 65, 129])
def test_wide_f32_kernel_at_tile_edges(gen, q_len, kv_len, causal):
    """q_len on each side of the 64-row q tiles and kv_len on each side of
    the 32-row kv tiles."""
    _f32_vs_plain(gen, 1, 8, 1, q_len, kv_len, 256, causal=causal)


def test_wide_f32_rowloop_jagged_lengths(gen):
    """The jagged mode of the wide f32 instance: lengths 0, 1, 63, 64, 65
    and the whole row; rows past a length are exactly 0 with the sentinel
    LSE."""
    d = 256
    lens = torch.tensor([0, 1, 63, 64, 65, 300], dtype=torch.int32,
                        device="cuda")
    q = _randn((6, 8, 300, d), torch.float32, gen)
    k = _randn((6, 1, 300, d), torch.float32, gen)
    v = _randn((6, 1, 300, d), torch.float32, gen)
    before = flash_attention_rowloop.launches
    out, lse = flash_attention_rowloop(q, k, v, causal=True, seq_lengths=lens)
    torch.cuda.synchronize()
    assert flash_attention_rowloop.launches == before + 1
    ref, ref_lse = flash_attention_rowloop_plain(
        q, k, v, causal=True, sm_scale=d ** -0.5, seq_lengths=lens)
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_rowloop_plain(
        x, k, v, causal=True, sm_scale=sc, seq_lengths=lens), q,
        torch.float32)
    for bi, L in enumerate(lens.tolist()):
        assert bool((out[bi, :, L:] == 0).all())
        torch.testing.assert_close(lse[bi, :, L:], ref_lse[bi, :, L:],
                                   rtol=1e-6, atol=0)   # the sentinel


@pytest.mark.parametrize("hq,hkv,masks", [
    (8, 8, "causal"), (8, 2, "window"), (8, 1, "ids"), (4, 2, "starts")])
def test_f32_fwd_runs_are_bit_identical_d256(gen, hq, hkv, masks):
    """The wide f32 forward merges each q tile's runs in run order: three
    calls give the same bits."""
    _f32_fwd_runs_agree(gen, hq, hkv, masks, 256)


@pytest.mark.parametrize("hq,hkv,masks", [
    (4, 4, "causal"), (8, 2, "window"), (8, 1, "ids"), (4, 2, "starts")])
def test_f32_bwd_runs_are_bit_identical_d256(gen, hq, hkv, masks):
    """The wide f32 backward's slots are summed in a fixed order: three
    runs give the same bits."""
    _f32_bwd_runs_agree(gen, hq, hkv, masks, 256)


@pytest.mark.parametrize("hq,hkv,q_len,kv_len,slots", [
    (8, 1, 8192, 8192, False), (2, 1, 4096, 32768, True)])
def test_wide_f32_fwd_workspace_stays_bounded(gen, hq, hkv, q_len, kv_len,
                                              slots):
    """The wide f32 merge's workspace stays within FLASH_FWD_F32_MAX_SLOTS
    slots of 64 x 258 f32 (under the 128 instance's 128 x 130): (1, 8,
    8192) causal fills the card with its q tiles, a 4096-row chunk over a
    32768-token cache splits. Each against the plain version."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        fwd_config, fwd_f32_slots, fwd_f32_work)

    d = 256
    cfg = fwd_config(torch.float32, head_dim=d)
    q = _randn((1, hq, q_len, d), torch.float32, gen)
    k, v = (_randn((1, hkv, kv_len, d), torch.float32, gen)
            for _ in range(2))
    before = _workspace_bytes()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    n_slots = fwd_f32_slots(*fwd_f32_work(q_len, kv_len, causal=True,
                                          n_bh=hq, cfg=cfg))[1]
    assert (n_slots > 0) == slots
    assert n_slots * hq <= configs.FLASH_FWD_F32_MAX_SLOTS
    bound = configs.FLASH_FWD_F32_MAX_SLOTS * 128 * (128 + 2) * 4 + 4096
    assert _workspace_bytes() <= max(before, bound)
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, return_lse=True), q,
        torch.float32)


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "starts",
                                  "full"])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("d", [192, 256])
def test_wide_f32_bwd_matches_plain(gen, d, group, mask):
    """The wide f32 backward against its plain version at the f32 gate,
    each mask, 1000 rows (not a multiple of the 32-row tiles) over 900 kv
    rows where causal is off; through flash_attention_bwd and autograd (at
    192 padded to 256)."""
    b, hkv = 2, 2 if group == 1 else 1
    q_len, kv_len = (1000, 900) if mask == "full" else (1000, 1000)
    q = _randn((b, hkv * group, q_len, d), torch.float32, gen)
    k = _randn((b, hkv, kv_len, d), torch.float32, gen)
    v = _randn((b, hkv, kv_len, d), torch.float32, gen)
    do = _randn((b, hkv * group, q_len, d), torch.float32, gen)
    kw, starts = {"causal": mask != "full"}, None
    if mask == "window":
        kw["window"] = 300
    if mask in ("ids", "starts"):
        seg = _segment_ids(b, q_len, (130, 480, 700), gen)
        kw["segment_ids"] = (seg, seg)
        if mask == "starts":
            starts = (0, 130, 480, 700)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, segment_starts=starts,
                              **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                     sm_scale=d ** -0.5, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= BWD_GATE[torch.float32], name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, segment_starts=starts, **kw).backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), leaves, got):
        assert torch.equal(t.grad, g), name


@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 12])
def test_wide_f32_decode_matches_plain(gen, group, fmt, ring):
    """f32 q at head_dim 256 over f32 pages (blocks of
    PAGED_DECODE_F32_WIDE_WARPS warps) and int8 pages, groups 1 to 12 (8
    and 12 as row blocks of G = 4), lengths 0 and 1, a page edge and past
    the table, in plain and ring mode, against the plain version at the
    kernel's splits and unsplit."""
    B, hkv, ps, P, d = 5, 1, 64, 10, 256
    num_pages = B * P + 3
    q = _randn((B, group, d), torch.float32, gen)
    pages = pack_paged_cache(
        _randn((hkv, num_pages, ps, d), torch.float32, gen),
        _randn((hkv, num_pages, ps, d), torch.float32, gen), fmt)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([0, 1, ps, P * ps - 5, 3 * P * ps + 30 if ring
                            else 10**6], dtype=torch.int32, device="cuda")
    window = 200 if ring else None
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    for splits in ("kernel", None):
        ref, ref_lse = fused_paged_decode_plain(
            q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
            window=window, splits=splits)
        assert _err(out, ref) <= tolerance_for(torch.float32)
        assert _err(lse, ref_lse) <= 1e-4
    assert bool((out[0] == 0).all())


def test_wide_f32_smem_layouts_match_configs(gen):
    """ops/configs.py's sizes are those of the wide f32 instances the
    libraries export: the forward's (fwd_smem_bytes) and the backward's
    (bwd_f32_smem_bytes)."""
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.ops.flash import check_smem_layouts
    from tiny_flash_attention_tpu_torch.ops.flash_bwd import check_f32_smem
    check_smem_layouts(_build.library("flash_fwd"), False)
    check_f32_smem(_build.library("flash_bwd"))


# --- head_dim 256 in the quantized forward and FA1 ---------------------------
# The quantized instances of B1's wide kernels (bf16 q: 64-row kv tiles in
# two stages, the payloads expanded in place; f32 q: the wide f32 body) and
# FA1's wide instances (bf16: 64-row kv tiles; f32: 32 x 32 tiles); head
# dims in (128, 256] pad to 256 (ops/dims.py).


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("hq,q_len,kv_len,masks", [
    (8, 300, 300, {"causal": True}),
    (1, 257, 129, {"causal": True}),
    (8, 65, 400, {"causal": True}),
    (2, 129, 257, {"causal": False}),
    (8, 300, 300, {"causal": True, "window": 61}),
    (8, 300, 300, {"causal": True, "ids": (37, 64, 65, 250),
                   "starts": True}),
], ids=["causal", "empty-rows", "offset", "noncausal", "window", "ids"])
def test_wide_quantized_kernel_matches_plain(gen, hq, q_len, kv_len, masks,
                                             fmt, dtype):
    """The quantized instances at head_dim 256 (over 1 kv head) against
    their plain version, out within the dtype gate of min(1, max|ref|),
    one launch of the format each call, segment_starts changing no bit;
    then 192 through the padded route: 3 pad copies, and on its true
    columns the bits of the call on the inputs padded to 256 by hand."""
    test_quantized_kernel_matches_plain(gen, 1, hq, 1, q_len, kv_len, 256,
                                        fmt, dtype, masks)
    q = _randn((1, hq, q_len, 192), dtype, gen)
    k, v = Q.quantize_kv(_randn((1, 1, kv_len, 192), torch.float32, gen),
                         _randn((1, 1, kv_len, 192), torch.float32, gen),
                         fmt)
    kw = {"causal": masks["causal"], "window": masks.get("window")}
    copies = pad_head_dim.copies
    out, lse = flash_attention_quantized(q, k, v, return_lse=True, **kw)
    assert pad_head_dim.copies == copies + 3
    kp, vp = (Q.QuantizedTensor(pad_head_dim(t.values, 256), t.scales)
              for t in (k, v))
    wide, wide_lse = flash_attention_quantized(
        pad_head_dim(q, 256), kp, vp, sm_scale=192 ** -0.5, return_lse=True,
        **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, wide[..., :192]) and torch.equal(lse, wide_lse)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_wide_quantized_runs_are_bit_identical(gen, fmt):
    """bf16 q over payloads at 256: the conversion and the sums run in a
    fixed order, so two calls give the same bits; no pad copy."""
    q = _randn((2, 8, 777, 256), torch.bfloat16, gen)
    k, v = Q.quantize_kv(_randn((2, 1, 777, 256), torch.float32, gen),
                         _randn((2, 1, 777, 256), torch.float32, gen), fmt)
    copies = pad_head_dim.copies
    one = flash_attention_quantized(q, k, v, causal=True, return_lse=True)
    two = flash_attention_quantized(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert pad_head_dim.copies == copies
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("h,q_len,kv_len,causal", [
    (2, 300, 260, True), (2, 300, 260, False), (4, 100, 333, True),
    (2, 300, 100, True), (1, 33, 31, False), (2, 1, 2100, True),
])
def test_wide_v1_kernel_matches_plain(gen, h, q_len, kv_len, causal, dtype):
    """FA1's wide instances at head_dim 256 against their plain version
    (bf16 also at the fold), one launch each; then 192 padded: 3 pad
    copies, and on its true columns the bits of the call on the inputs
    padded by hand."""
    test_v1_kernel_matches_plain(gen, 1, h, q_len, kv_len, 256, causal,
                                 dtype)
    q = _randn((1, h, q_len, 192), dtype, gen)
    k, v = (_randn((1, h, kv_len, 192), dtype, gen) for _ in range(2))
    copies = pad_head_dim.copies
    out, lse = flash_attention_v1(q, k, v, causal=causal, return_lse=True)
    assert pad_head_dim.copies == copies + 3
    wide, wide_lse = flash_attention_v1(
        *(pad_head_dim(t, 256) for t in (q, k, v)), causal=causal,
        sm_scale=192 ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, wide[..., :192]) and torch.equal(lse, wide_lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_wide_v1_runs_are_bit_identical(gen, dtype):
    """FA1 at 256: every state round trip in a fixed order, two calls the
    same bits."""
    q = _randn((2, 4, 700, 256), dtype, gen)
    k, v = (_randn((2, 4, 700, 256), dtype, gen) for _ in range(2))
    one = flash_attention_v1(q, k, v, causal=True, return_lse=True)
    two = flash_attention_v1(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_wide_quantized_and_v1_smem_layouts_match_configs(gen):
    """ops/configs.py's fwd_smem_bytes (quantized) and v1_smem_bytes give
    the shared memory the libraries' instances take, the head_dim-256 ones
    included."""
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.ops.flash import check_smem_layouts
    from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
        check_smem_layout)
    check_smem_layouts(_build.library("flash_fwd_quant"), True)
    check_smem_layout(_build.library("flash_v1"))


# --- context parallelism: worlds of ranks on this card (parallel/) ---------

def _cp_inputs(gen, b=1, hq=6, hkv=2, seq=4096, d=128):
    q = _randn((b, hq, seq, d), torch.bfloat16, gen)
    k, v = (_randn((b, hkv, seq, d), torch.bfloat16, gen) for _ in range(2))
    return q, k, v


def test_cp_world_of_two_on_gloo_matches_b1(gen):
    """The ranks share the card over gloo (host-staged); each mode's output
    against the plain version over the whole sequence (the dtype gate on
    out, the row gate at the fold) and against B1 over it (the same gates;
    B1 folds q as fold_q does)."""
    q, k, v = _cp_inputs(gen)
    cpu = [t.cpu() for t in (q, k, v)]
    cases = [("ring causal", "ring", cpu, {"causal": True}),
             ("ring non-causal", "ring", cpu, {"causal": False}),
             ("zigzag", "zigzag", cpu, {})]
    ranks = run_world(RK.run_cases, 2, backend="gloo", device_type="cuda",
                      args=(((2,), ("ctx",)), cases), timeout_s=300)
    sm_scale = q.shape[-1] ** -0.5
    for name, _, _, opts in cases:
        causal = opts.get("causal", True)
        ref = flash_attention(q, k, v, causal=causal)
        plain = flash_attention_plain(q, k, v, causal=causal,
                                      sm_scale=sm_scale)
        fq, fscale = fold_q(q, sm_scale)
        plain_fold = flash_attention_plain(fq, k, v, causal=causal,
                                           sm_scale=fscale)
        for got in ranks:
            out = got[name].cuda()
            assert _err(out, plain) <= tolerance_for(torch.bfloat16), name
            assert row_err(out, plain_fold) <= BF16_ROW_GATE, name
            assert _err(out, ref) <= tolerance_for(torch.bfloat16), name
            assert row_err(out, ref) <= BF16_ROW_GATE, name


def test_cp_world_of_one_on_nccl_is_b1(gen):
    """At n = 1 the merge is exact (x 1 plus 0): every mode gives B1's
    bits, through NCCL's collectives."""
    q, k, v = _cp_inputs(gen, seq=2048)
    cpu = [t.cpu() for t in (q, k, v)]
    cases = [("ring", "ring", cpu, {"causal": True}),
             ("zigzag", "zigzag", cpu, {}),
             ("ulysses", "ulysses", cpu, {"causal": True}),
             ("allgather", "allgather", cpu, {})]
    got = run_world(RK.run_cases, 1, backend="nccl", device_type="cuda",
                    args=(((1,), ("ctx",)), cases), timeout_s=300)[0]
    for name, _, _, opts in cases:
        ref = flash_attention(q, k, v,
                              causal=opts.get("causal", name == "zigzag"))
        assert torch.equal(got[name].cuda(), ref), name


def test_nccl_refuses_two_ranks_on_one_card(gen):
    with pytest.raises(ValueError, match="nccl needs a CUDA card"):
        run_world(RK.fail_on_rank, torch.cuda.device_count() + 1,
                  backend="nccl", device_type="cuda", args=(-1,))


def test_cp_ring_backward_raises_on_the_card(gen):
    """The ring's flash calls ask for the LSE, forward-only on the card as
    in JAX: a backward through the ring raises in the rank, and the world
    fails."""
    cpu = [t.cpu() for t in _cp_inputs(gen, seq=256)]
    with pytest.raises(RuntimeError, match="has no backward"):
        run_world(RK.run_cases, 1, backend="nccl", device_type="cuda",
                  args=(((1,), ("ctx",)),
                        [("grad", "ring", cpu, {"causal": True,
                                                "grad": True})]),
                  timeout_s=300)


def test_failing_rank_fails_the_world_on_the_card(gen):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_world(RK.fail_on_rank, 2, backend="gloo", device_type="cuda",
                  args=(1,), timeout_s=300)


@pytest.mark.parametrize("fmt,mode", [
    ("bf16", "batched"), ("int8", "batched"), ("bf16", "packed-page"),
    ("bf16", "packed-pow2"), ("bf16", "jagged")])
def test_sharded_engine_world_of_one_is_single_card(gen, fmt, mode):
    """parallel/serve.py on a (1, 1) mesh, one rank on NCCL: tp = 1, so
    every all-reduce is the single-card residual add, and the tokens and
    the pages equal the single-card engine's bit for bit, in every
    admission mode."""
    fields = dict(vocab_size=512, d_model=256, n_layers=2, n_q_heads=4,
                  n_kv_heads=2, d_head=128, d_ff=512, dtype=torch.bfloat16)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 512, (n,), generator=rng).tolist()
               for n in (9, 200, 130, 33)]
    got = run_world(SR.card_world_of_one, 1, backend="nccl",
                    device_type="cuda",
                    args=(fields, 0, prompts, fmt, mode))[0]
    assert got["tokens"][0] == got["tokens"][1]
    assert got["same_pages"]


# --- the run-time config, the autotuner and the CPU oracle -----------------


def test_default_config_explicit_gives_the_same_bits(gen):
    """config=default_config(...) is a call without config, bit for bit:
    B1 bf16 (at 96, the narrow instance) and f32 (its kv runs), the
    quantized forward (bf16 and f32 q over int8) and B11's jagged mode;
    the 128-wide instance at 96 gives the same bits too."""
    for dtype, d in ((torch.bfloat16, 96), (torch.float32, 128)):
        q = _randn((2, 4, 700, d), dtype, gen)
        k, v = _randn((2, 2, 700, d), dtype, gen), _randn((2, 2, 700, d),
                                                          dtype, gen)
        cfg = configs.default_config(dtype, d, 700, 700)
        want = flash_attention(q, k, v, causal=True, return_lse=True)
        for c in (cfg, dataclasses.replace(cfg, narrow_products=False)):
            got = flash_attention(q, k, v, causal=True, config=c,
                                  return_lse=True)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        kq, vq = Q.quantize_kv(k, v, "int8")
        assert torch.equal(
            flash_attention_quantized(q, kq, vq, causal=True),
            flash_attention_quantized(q, kq, vq, causal=True, config=cfg))
        lens = torch.tensor([700, 129], dtype=torch.int32, device="cuda")
        assert all(torch.equal(a, b) for a, b in zip(
            flash_attention_rowloop(q, k, v, causal=True, seq_lengths=lens),
            flash_attention_rowloop(q, k, v, causal=True, seq_lengths=lens,
                                    config=cfg)))


def test_config_runs_and_refusals_on_the_card(gen, monkeypatch):
    """Other f32 runs (longer, shorter, none) stay within 2e-5 of the
    default's and of the plain version, the backward's runs
    (FLASH_BWD_F32_SPLIT) too; a config the check refuses raises
    ValueError before any launch."""
    q = _randn((1, 8, 1024, 128), torch.float32, gen)
    k, v = (_randn((1, 2, 1024, 128), torch.float32, gen) for _ in "kv")
    want = flash_attention_plain(q, k, v, causal=True, sm_scale=128 ** -0.5)
    base = flash_attention(q, k, v, causal=True)
    do = _randn(q.shape, torch.float32, gen)
    grads = []
    for split in (configs.FLASH_BWD_F32_SPLIT, 3):
        monkeypatch.setattr(configs, "FLASH_BWD_F32_SPLIT", split)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        grads.append(torch.autograd.grad(out, leaves, do))
    for a, b in zip(*grads):
        assert _err(a, b) <= 2e-5
    for split in (1, 2, 20, 16):
        cfg = configs.FlashConfig(f32_split=split)
        got = flash_attention(q, k, v, causal=True, config=cfg)
        assert _err(got, base) <= 2e-5 and _err(got, want) <= 2e-5
    launches = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, v, config=configs.FlashConfig(f32_split=0))
    assert flash_attention.launches == launches


def test_autotune_on_the_card(gen, tmp_path):
    """The autotuner times every candidate on the card and returns one of
    them, memoized (no launch the second time); its output is within 2e-5
    of the default call's (f32) or its bits (bf16 at 80: the narrow
    instance or the 128-wide one); the cache round-trips."""
    from tiny_flash_attention_tpu_torch.utils import autotune as AT

    AT._CACHE.clear()
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 80)):
        q = _randn((1, 8, 1024, d), dtype, gen)
        k, v = (_randn((1, 2, 1024, d), dtype, gen) for _ in "kv")
        cands = AT._candidates(configs.default_config(dtype, d, 1024, 1024),
                               q.shape, k.shape, dtype)
        assert len(cands) >= 2
        cfg = AT.autotune_flash_config(q, k, v, causal=True, rounds=2)
        assert cfg in cands and len(AT.last_timings) == len(cands)
        assert all(r["device"] == "cuda" and r["min_ms"] > 0
                   for _, r in AT.last_timings)
        launches = flash_attention.launches
        assert AT.autotune_flash_config(q, k, v, causal=True) is cfg
        assert flash_attention.launches == launches
        got = flash_attention(q, k, v, causal=True, config=cfg)
        base = flash_attention(q, k, v, causal=True)
        if dtype == torch.bfloat16:
            assert torch.equal(got, base)
        else:
            assert _err(got, base) <= 2e-5
    path = str(tmp_path / "tune.json")
    AT.save_cache(path)
    kept = dict(AT._CACHE)
    AT._CACHE.clear()
    assert AT.load_cache(path) == 2 and AT._CACHE == kept
    AT._CACHE.clear()


def test_cpu_oracle_on_the_card_host(gen):
    """cpu.py builds on the card's host and agrees with B1 copied back; a
    CUDA tensor raises ValueError (nothing is copied quietly)."""
    from tiny_flash_attention_tpu_torch import cpu

    q = _randn((1, 4, 256, 128), torch.float32, gen)
    k, v = (_randn((1, 2, 256, 128), torch.float32, gen) for _ in "kv")
    with pytest.raises(ValueError, match="CPU tensors"):
        cpu.flash_attn(q, k, v)
    for causal in (False, True):
        got = cpu.flash_attn(q.cpu(), k.cpu(), v.cpu(), causal=causal)
        assert _err(got, flash_attention(q, k, v, causal=causal).cpu()) \
            <= 2e-5
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        got = cpu.flash_attn_bf16(qb.cpu(), kb.cpu(), vb.cpu(),
                                  causal=causal)
        assert _err(got, flash_attention(qb, kb, vb, causal=causal).cpu()) \
            <= 2e-2


# --- every head_dim and page size: the run-time width instances ---------------
# The decodes and the append take every head_dim up to 256 and every page
# size the JAX package takes; at a head_dim or page size without a compiled
# instance they run on the run-time width instances (ops/dims.py::
# decode_width), which read rows of the true width in place.

WIDTH_PAGE_SIZES = (24, 1, 48, 8)


def _width_pages(gen, fmt, dtype, d, ps, hkv, num_pages):
    """Fused pages of `fmt` ("bf16": q's dtype, or "int8") from random K/V."""
    return pack_paged_cache(_randn((hkv, num_pages, ps, d), dtype, gen),
                            _randn((hkv, num_pages, ps, d), dtype, gen),
                            fmt)


def _width_table(gen, B, P, num_pages):
    return torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)


def _check_width_decode(gen, fmt, dtype, d, ps, group, window=None):
    """B4 over fused pages at (d, ps) against its plain version at the
    kernel's splits and unsplit: lengths 0, 1, a page edge, a ragged one and
    the full table (ring mode: lengths past the ring's capacity)."""
    B, hkv = 5, 2
    P = max(3, -(-100 // ps)) if ps < 32 else 3
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), dtype, gen)
    pages = _width_pages(gen, fmt, dtype, d, ps, hkv, num_pages)
    table = _width_table(gen, B, P, num_pages)
    cap = P * ps
    lengths = torch.tensor(
        [0, 1, ps, cap // 2 + 1, cap] if window is None
        else [1, window - 1, cap + 9, 3 * cap + 5, cap],
        dtype=torch.int32, device="cuda")
    before = fused_paged_decode_attention.width_launches
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    assert fused_paged_decode_attention.width_launches == before + (
        not decode_compiled(d, ps))
    for splits in ("kernel", None):
        ref, ref_lse = fused_paged_decode_plain(
            q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
            window=window, splits=splits)
        assert _err(out, ref) <= tolerance_for(dtype), (d, ps, splits)
        assert _err(lse, ref_lse) <= tolerance_for(dtype), (d, ps, splits)
    if window is None:
        assert bool((out[0] == 0).all())


def _check_width_separate(gen, fmt, dtype, d, ps, group):
    """B12 at (d, ps) against its plain version at the kernel's splits."""
    B, hkv = 4, 2
    P = max(3, -(-100 // ps)) if ps < 32 else 3
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), dtype, gen)
    k = _randn((hkv, num_pages, ps, d), dtype, gen)
    v = _randn((hkv, num_pages, ps, d), dtype, gen)
    if fmt == "int8":
        k, v = Q.quantize_int8(k, axis=-1), Q.quantize_int8(v, axis=-1)
    table = _width_table(gen, B, P, num_pages)
    lengths = torch.tensor([1, ps, P * ps // 2 + 1, P * ps],
                           dtype=torch.int32, device="cuda")
    before = paged_decode_attention.width_launches
    out, lse = paged_decode_attention(q, k, v, lengths, table)
    torch.cuda.synchronize()
    assert paged_decode_attention.width_launches == before + (
        not decode_compiled(d, ps))
    ref, ref_lse = paged_decode_plain(q, k, v, lengths, table,
                                      sm_scale=d ** -0.5, splits="kernel")
    assert _err(out, ref) <= tolerance_for(dtype), (d, ps)
    assert _err(lse, ref_lse) <= tolerance_for(dtype), (d, ps)


def _check_width_append(gen, fmt, src, d, ps):
    """B5 at (d, ps) bit for bit against its plain version, an all-zero
    row (scale 1) and a page's last row included."""
    B, hkv, num_pages = 5, 2, 7
    pdtype = torch.int8 if fmt == "int8" else src
    pages = torch.randint(-100, 100, (hkv, num_pages, page_rows(ps, d, fmt),
                                      d), generator=gen, device="cuda"
                          ).to(pdtype)
    k_new = _randn((B, hkv, d), src, gen) * 3
    v_new = _randn((B, hkv, d), src, gen)
    k_new[1, 0] = 0.0
    ids = torch.tensor([0, 6, 3, 2, 5], dtype=torch.int32, device="cuda")
    rows = torch.tensor([0, ps - 1, ps // 2, (ps * 2) // 3, 0],
                        dtype=torch.int32, device="cuda")
    want = page_append_plain(pages.clone(), k_new, v_new, ids, rows,
                             page_size=ps)
    before = fused_page_append.width_launches
    got = fused_page_append(pages, k_new, v_new, ids, rows, page_size=ps)
    torch.cuda.synchronize()
    assert fused_page_append.width_launches == before + (
        d not in DECODE_HEAD_DIMS)
    assert torch.equal(got.view(torch.uint8) if fmt == "int8" else got,
                       want.view(torch.uint8) if fmt == "int8" else want)


@pytest.mark.parametrize("d", range(1, 257))
def test_width_decode_every_head_dim(gen, d):
    """B4 over bf16 pages at each head_dim 1 to 256, the page size cycling
    through 24, 1, 48 and 8, group 3 (padded to 4)."""
    _check_width_decode(gen, "bf16", torch.bfloat16, d,
                        WIDTH_PAGE_SIZES[d % 4], 3)


@pytest.mark.parametrize("d", range(1, 257))
def test_width_separate_decode_every_head_dim(gen, d):
    """B12 over bf16 pages at each head_dim 1 to 256, the page size cycling
    through 24, 1, 48 and 8, group 2."""
    _check_width_separate(gen, "bf16", torch.bfloat16, d,
                          WIDTH_PAGE_SIZES[d % 4], 2)


@pytest.mark.parametrize("d", range(1, 257))
def test_width_append_every_head_dim(gen, d):
    """B5 into bf16 pages at each head_dim 1 to 256 bit for bit, the page
    size cycling through 24, 1, 48 and 8."""
    _check_width_append(gen, "bf16", torch.bfloat16, d,
                        WIDTH_PAGE_SIZES[d % 4])


WIDTH_DIMS = (8, 36, 48, 72, 100, 112, 160, 192, 248)
WIDTH_FORMATS = [(fmt, d, ps) for fmt in ("f32", "int8 bf16", "int8 f32")
                 for d in WIDTH_DIMS for ps in (1, 8, 24, 48, 100)
                 if not fmt.startswith("int8") or ps <= d or ps % d == 0]


@pytest.mark.parametrize("fmt,d,ps", WIDTH_FORMATS)
def test_width_decode_formats(gen, fmt, d, ps):
    """B4 with f32 q over f32 pages and bf16 or f32 q over int8 pages at
    the head dims and page sizes of chip_smoke.py's decode-widths phase
    (int8 where JAX's page rule admits the pair), groups 1, 3 and 8 by
    turn, the ring mode at page size 48."""
    dtype = torch.float32 if fmt.endswith("f32") else torch.bfloat16
    page_fmt = "int8" if fmt.startswith("int8") else "bf16"
    group = (1, 3, 8)[(d + ps) % 3]
    _check_width_decode(gen, page_fmt, dtype, d, ps, group,
                        window=50 if ps == 48 else None)


@pytest.mark.parametrize("fmt,d,ps", [
    (fmt, d, ps) for fmt in ("f32", "int8 bf16", "int8 f32")
    for d in WIDTH_DIMS for ps in (1, 8, 24, 48, 100)
    if not fmt.startswith("int8") or ps <= d or ps % d == 0])
def test_width_append_formats(gen, fmt, d, ps):
    """B5 with f32 rows into f32 pages and bf16 or f32 rows into int8 pages
    (quantized, the scale bytes at row 2ps + 4 (row / d) + j, lane row % d)
    bit for bit, at the decode-widths phase's head dims and page sizes."""
    src = torch.float32 if fmt.endswith("f32") else torch.bfloat16
    _check_width_append(gen, "int8" if fmt.startswith("int8") else "bf16",
                        src, d, ps)


@pytest.mark.parametrize("d", WIDTH_DIMS)
@pytest.mark.parametrize("ps", [1, 48, 128])
def test_width_separate_decode_f32_and_int8(gen, d, ps):
    """B12 with f32 q over f32 pages, and over int8 pages with f32 scales
    where JAX takes them (page size a multiple of 128)."""
    _check_width_separate(gen, "bf16", torch.float32, d, ps, 3)
    if ps % 128 == 0:
        _check_width_separate(gen, "int8", torch.bfloat16, d, ps, 3)


@pytest.mark.parametrize("d", DECODE_HEAD_DIMS)
@pytest.mark.parametrize("ps", [16, 32, 64, 128, 48])
def test_compiled_widths_keep_their_instances(gen, d, ps):
    """64, 80, 96, 128, 256 and 512 at page size 16 or a multiple of 32
    launch the compiled widths (csrc/paged_decode.cu, paged_decode_f32.cu,
    paged_decode_separate.cu, at 512 paged_decode_wide.cu and
    paged_decode_separate_wide.cu, and their own append instances: no
    run-time width launch); the same head dims at page size 48 launch the
    run-time width instances. Each against its plain version; at 512 also
    the decodes with f32 q over f32 and int8 pages (csrc/
    paged_decode_f32_wide.cu, paged_decode_separate_f32_wide.cu), on their
    compiled instance of width 512 or the run-time one."""
    assert decode_compiled(d, ps) == (ps != 48)
    for fmt, dtype in (("bf16", torch.bfloat16), ("int8", torch.bfloat16),
                       ("bf16", torch.float32)):
        if fmt == "int8" and not (ps <= d or ps % d == 0):
            continue
        _check_width_decode(gen, fmt, dtype, d, ps, 2)
        _check_width_append(gen, fmt, dtype, d, ps)
    _check_width_separate(gen, "bf16", torch.bfloat16, d, ps, 2)
    if d == 512:
        _check_width_decode(gen, "int8", torch.float32, d, ps, 2)
        _check_width_separate(gen, "bf16", torch.float32, d, ps, 2)


# --- head dims 257-512 in f32: the instances of width 512 -----------------------
# B1's f32 body over 32-row q and kv tiles with K and V in one buffer each
# (head dims in (256, 512] padded to 512), the decodes with f32 q on their
# instances of width 512 (f32 pages in 16-token chunks).


@pytest.mark.parametrize("mask", ["causal", "window", "ids", "full",
                                  "offset"])
@pytest.mark.parametrize("group", [1, 8, 64])
@pytest.mark.parametrize("d", [264, 384, 512])
def test_wider_f32_flash_kernel_matches_plain(gen, d, group, mask):
    """B1's f32 instance of width 512 against its plain version at the f32
    gate: 300 rows (not a multiple of its 32-row tiles), each mask, the
    decode offset (130 q rows over 300 kv rows); below 512 through the
    padded route, its copies counted."""
    kw = {"causal": mask != "full"}
    q_len = 130 if mask == "offset" else 300
    if mask == "window":
        kw["window"] = 61
    if mask == "ids":
        seg = _ids(2, 300, gen)
        kw["segment_ids"] = (seg, seg)
    hkv = 2 if group < 8 else 1
    copies = pad_head_dim.copies
    _f32_vs_plain(gen, 2, hkv * group, hkv, q_len, 300, d, **kw)
    assert pad_head_dim.copies == copies + (3 if d != 512 else 0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 65, 257])
@pytest.mark.parametrize("q_len", [1, 31, 32, 33, 97])
def test_wider_f32_kernel_at_tile_edges(gen, q_len, kv_len, causal):
    """q_len and kv_len on each side of the 32-row q and kv tiles of the
    f32 instance of width 512."""
    _f32_vs_plain(gen, 1, 8, 1, q_len, kv_len, 512, causal=causal)


def test_wider_f32_rowloop_jagged_lengths(gen):
    """The jagged mode of the f32 instance of width 512 at head_dim 448:
    lengths 0, 1, 31, 32, 33 and the whole row; rows past a length are
    exactly 0 with the sentinel LSE."""
    d = 448
    lens = torch.tensor([0, 1, 31, 32, 33, 300], dtype=torch.int32,
                        device="cuda")
    q = _randn((6, 8, 300, d), torch.float32, gen)
    k = _randn((6, 1, 300, d), torch.float32, gen)
    v = _randn((6, 1, 300, d), torch.float32, gen)
    before = flash_attention_rowloop.launches
    out, lse = flash_attention_rowloop(q, k, v, causal=True, seq_lengths=lens)
    torch.cuda.synchronize()
    assert flash_attention_rowloop.launches == before + 1
    _, ref_lse = flash_attention_rowloop_plain(
        q, k, v, causal=True, sm_scale=d ** -0.5, seq_lengths=lens)
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_rowloop_plain(
        x, k, v, causal=True, sm_scale=sc, seq_lengths=lens), q,
        torch.float32)
    for bi, L in enumerate(lens.tolist()):
        assert bool((out[bi, :, L:] == 0).all())
        torch.testing.assert_close(lse[bi, :, L:], ref_lse[bi, :, L:],
                                   rtol=1e-6, atol=0)   # the sentinel


@pytest.mark.parametrize("hq,hkv,masks", [
    (8, 8, "causal"), (8, 2, "window"), (8, 1, "ids"), (4, 2, "starts")])
def test_f32_fwd_runs_are_bit_identical_d512(gen, hq, hkv, masks):
    """The f32 instance of width 512 merges each q tile's runs in run
    order: three calls give the same bits."""
    _f32_fwd_runs_agree(gen, hq, hkv, masks, 512)


@pytest.mark.parametrize("hq,hkv,q_len,kv_len,slots", [
    (8, 1, 8192, 8192, False), (2, 1, 4096, 32768, True)])
def test_wider_f32_fwd_workspace_stays_bounded(gen, hq, hkv, q_len, kv_len,
                                               slots):
    """The width-512 f32 merge's workspace stays within
    FLASH_FWD_F32_MAX_SLOTS slots of 32 x 514 f32 (69.4 MB): (1, 8, 8192)
    causal fills the card with its q tiles, a 4096-row chunk over a
    32768-token cache splits. Each against the plain version."""
    from tiny_flash_attention_tpu_torch.ops.flash import (
        fwd_config, fwd_f32_slots, fwd_f32_work)

    d = 512
    cfg = fwd_config(torch.float32, head_dim=d)
    q = _randn((1, hq, q_len, d), torch.float32, gen)
    k, v = (_randn((1, hkv, kv_len, d), torch.float32, gen)
            for _ in range(2))
    before = _workspace_bytes()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    n_slots = fwd_f32_slots(*fwd_f32_work(q_len, kv_len, causal=True,
                                          n_bh=hq, cfg=cfg))[1]
    assert (n_slots > 0) == slots
    assert n_slots * hq <= configs.FLASH_FWD_F32_MAX_SLOTS
    bound = configs.FLASH_FWD_F32_MAX_SLOTS * 32 * (512 + 2) * 4 + 4096
    assert _workspace_bytes() <= max(before, bound)
    _assert_flash_gate(out, lse, lambda x, sc: flash_attention_plain(
        x, k, v, causal=True, sm_scale=sc, return_lse=True), q,
        torch.float32)


def test_wider_f32_smem_layout_matches_configs(gen):
    """ops/configs.py::fwd_smem_bytes gives the shared memory of the f32
    instance of width 512 that the library exports (200,832 bytes)."""
    from tiny_flash_attention_tpu_torch import _build
    from tiny_flash_attention_tpu_torch.ops.flash import check_smem_layouts
    lib = _build.library("flash_fwd")
    check_smem_layouts(lib, False)
    assert lib.tfa_flash_fwd_smem(1, 512) == configs.fwd_smem_bytes(
        configs.FLASH_FWD_F32_512, 512) == 200832


@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("d,ps,group", [(512, 64, 1), (512, 128, 64),
                                        (512, 48, 8), (384, 64, 2),
                                        (300, 1, 8), (448, 32, 64)])
def test_wider_f32_decode_matches_plain(gen, d, ps, group, fmt, ring):
    """B4 with f32 q at head dims 300-512 (compiled at 512 with page size
    16 or a multiple of 32, at run time otherwise), groups as row blocks
    of DECODE_TOP_512 q rows, over f32 pages ("bf16": the model dtype's)
    and int8 pages, in plain and ring mode, against the plain version at
    the kernel's splits at the f32 gate; the run-time width instances
    count their launches."""
    B, hkv = 4, 1
    P = -(-600 // ps)
    num_pages = B * P + 3
    q = _randn((B, hkv * group, d), torch.float32, gen)
    pages = pack_paged_cache(
        _randn((hkv, num_pages, ps, d), torch.float32, gen),
        _randn((hkv, num_pages, ps, d), torch.float32, gen), fmt)
    table = torch.randperm(num_pages, generator=gen, device="cuda")[
        :B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([1, ps, P * ps - 5, 3 * P * ps + 30 if ring
                            else P * ps], dtype=torch.int32, device="cuda")
    window = min(200, P * ps) if ring else None
    widths = fused_paged_decode_attention.width_launches
    out, lse = fused_paged_decode_attention(q, pages, lengths, table,
                                            page_size=ps, window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert fused_paged_decode_attention.width_launches == widths + (
        not decode_compiled(d, ps))
    for splits in ("kernel", None):
        ref, ref_lse = fused_paged_decode_plain(
            q, pages, lengths, table, page_size=ps, sm_scale=d ** -0.5,
            window=window, splits=splits)
        assert _err(out, ref) <= tolerance_for(torch.float32)
        assert _err(lse, ref_lse) <= tolerance_for(torch.float32)


@pytest.mark.parametrize("d,ps,group,fmt", [
    (512, 128, 64, "f32"), (384, 48, 8, "f32"), (300, 128, 1, "f32"),
    (512, 16, 2, "f32"), (512, 128, 64, "int8"), (300, 128, 8, "int8")])
def test_wider_f32_separate_decode_matches_plain(gen, d, ps, group, fmt):
    """B12 with f32 q at head dims 300-512 over f32 pages and int8 pages
    (page size 128: JAX takes separate int8 pages at multiples of 128)
    against its plain version at the kernel's splits, at the f32 gate."""
    _check_width_separate(gen, "int8" if fmt == "int8" else "bf16",
                          torch.float32, d, ps, group)

