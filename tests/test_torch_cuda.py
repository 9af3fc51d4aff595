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
tables.
"""

import pytest
import torch

from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd, flash_attention_bwd_plain)
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop, flash_attention_rowloop_plain)
from tiny_flash_attention_tpu_torch.ops.flash_v1 import (
    flash_attention_v1, flash_attention_v1_plain)
from tiny_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attention, paged_decode_plain)
from tiny_flash_attention_tpu_torch.ops import quant as Q
from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    fused_page_append, fused_paged_decode_attention, fused_paged_decode_plain,
    pack_paged_cache, page_append_plain, page_rows)
from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
    quantized_matmul_cuda, quantized_matmul_plain)
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

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
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=d ** -0.5, return_lse=True)
    atol = tolerance_for(dtype)
    assert _err(out, ref) <= atol
    assert _err(lse, ref_lse) <= atol


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
    with pytest.raises(NotImplementedError):
        flash_attention(_randn((1, 2, 8, 96), torch.bfloat16, gen),
                        _randn((1, 2, 8, 96), torch.bfloat16, gen),
                        _randn((1, 2, 8, 96), torch.bfloat16, gen))
    q96 = _randn((1, 2, 8, 96), torch.bfloat16, gen)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd(q96, q96, q96, q96,
                            torch.zeros((1, 2, 8), device="cuda"), q96,
                            causal=True)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd(q, q.float(), q.float(), q,
                            torch.zeros((1, 2, 64), device="cuda"), q,
                            causal=True)


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
    ref, ref_lse = flash_attention_plain(
        q, k, v, causal=causal, sm_scale=d ** -0.5,
        segment_ids=(q_seg, seg), return_lse=True)
    atol = tolerance_for(dtype)
    assert _err(out, ref) <= atol and _err(lse, ref_lse) <= atol
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
    atol = tolerance_for(dtype)
    assert _err(out, ref) <= atol and _err(lse, ref_lse) <= atol
    for bi, L in enumerate(lens.tolist()):
        assert bool((out[bi, :, L:] == 0).all())
        torch.testing.assert_close(lse[bi, :, L:], ref_lse[bi, :, L:],
                                   rtol=1e-6, atol=0)   # the sentinel
    for q_len, causal in ((192, False), (40, True)):
        out, lse = flash_attention_rowloop(q[:, :, :q_len], k, v,
                                           causal=causal)
        ref, ref_lse = flash_attention_rowloop_plain(
            q[:, :, :q_len], k, v, causal=causal, sm_scale=128 ** -0.5)
        assert _err(out, ref) <= atol and _err(lse, ref_lse) <= atol


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
    return {
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
    "flash_attention(return_lse=True)", "flash_attention_rowloop",
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
    (torch.float32, "int8", 256, 128), (torch.bfloat16, "int8", 128, 64)])
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
])
def test_v1_kernel_matches_plain(gen, b, h, q_len, kv_len, d, causal, dtype):
    """The FA1 kernel against its plain version; rows that see no column
    are 0 with the sentinel LSE in both."""
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
    if causal and q_len > kv_len:
        assert bool((out[:, :, :q_len - kv_len] == 0).all())


@pytest.mark.parametrize("fmt,group,d,ps", [
    ("bf16", 1, 64, 16), ("bf16", 4, 128, 128), ("bf16", 8, 64, 64),
    ("f32", 2, 128, 16), ("f32", 4, 64, 128),
    ("int8 bf16", 1, 64, 128), ("int8 bf16", 4, 128, 128),
    ("int8 bf16", 8, 128, 256), ("int8 f32", 2, 64, 128),
    ("int8 f32", 4, 128, 256)])
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
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True,
                                         sm_scale=d ** -0.5, window=window,
                                         return_lse=True)
    atol = tolerance_for(dtype)
    assert _err(out, ref) <= atol and _err(lse, ref_lse) <= atol
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
    ref, ref_lse = flash_attention_plain(
        q, k, v, causal=True, sm_scale=128 ** -0.5, window=50,
        segment_ids=(seg, seg), return_lse=True)
    atol = tolerance_for(dtype)
    assert _err(out, ref) <= atol and _err(lse, ref_lse) <= atol
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
