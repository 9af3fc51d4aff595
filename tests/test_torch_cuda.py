"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test skips where no CUDA card is present (this decision
is taken inside the fixture, never at import). On a machine with a card and
without JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(the repository's conftest imports JAX to pin it to the CPU). The shapes
here are the odd ones chip_smoke.py does not reach: ragged tiles, head_dim
64, every supported GQA group, f32, length 0 and sliced page tables.
"""

import pytest
import torch

from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd, flash_attention_bwd_plain)
from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    fused_paged_decode_attention, fused_paged_decode_plain)
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
        flash_attention(q, q, q, causal=True, window=16)
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
