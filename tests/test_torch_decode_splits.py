"""The split decode's plain version and its split plan, on the CPU.

The decode kernels (B4 over fused pages, B12 over separate arrays) split
each sequence's attended tokens into page-aligned ranges, one block each,
and merge the ranges' softmax states in split order. Their plain version
with `splits=k` computes the same partials and merge; here it runs against
the JAX package's `_fused_decode_kernel` in interpret mode on the same
numpy inputs (bf16, f32 and int8 pages, the ring mode included), at k in
{1, 2, 3, 7}: splits with no live token, lengths 0 and 1, a page edge, a
ragged length and the full table. Length 0 gives out 0 and the LSE
sentinel, where JAX leaves the row unwritten (ROADMAP's held divergence;
its kernel then also garbles the rows after it, so JAX gets the live rows
only): those rows are held to the unsplit plain version. Then the plan
itself: the ranges tile the attended tokens exactly, on page edges, in
order, and the split count is set by the table's width, not the lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.ops import paged_fused as jpf
from tiny_flash_attention_tpu_torch.ops import configs
from tiny_flash_attention_tpu_torch.ops import paged as tpd
from tiny_flash_attention_tpu_torch.ops import paged_fused as tpf
from tiny_flash_attention_tpu_torch.ops.quant import QuantizedTensor
from tiny_flash_attention_tpu_torch.utils.testing import tolerance_for

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
B, HKV, GROUP, D, PS, P = 5, 2, 4, 64, 16, 6
WINDOW = 40


def _case(fmt, ring, seed):
    """(q, pages, lengths, table, window) in torch and the JAX pages."""
    rng = np.random.default_rng(seed)
    dtype = torch.float32 if fmt == "f32" else torch.bfloat16
    n_pages = B * P + 3
    q = torch.from_numpy(
        rng.standard_normal((B, HKV * GROUP, D)).astype(np.float32)).to(dtype)
    kp, vp = (rng.standard_normal((HKV, n_pages, PS, D)).astype(np.float32)
              for _ in range(2))
    if fmt == "int8":
        jpages = jpf.pack_paged_cache(jnp.asarray(kp), jnp.asarray(vp),
                                      "int8")
        pages = torch.from_numpy(np.array(jpages))
    else:
        pages = tpf.pack_paged_cache(torch.from_numpy(kp).to(dtype),
                                     torch.from_numpy(vp).to(dtype))
        jpages = jnp.asarray(pages.float().numpy(), _JNP[dtype])
    table = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    if ring:   # inside the table, a page edge, wrapped once and 3 times
        lengths = [1, 2 * PS, P * PS + 9, 3 * P * PS + 30, 17]
    else:      # length 0 and 1, a page edge, the full table, a ragged one
        lengths = [0, 1, PS, P * PS, 37]
    return (q, pages, torch.tensor(lengths, dtype=torch.int32),
            torch.from_numpy(table), WINDOW if ring else None, jpages)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("fmt", ["bf16", "f32", "int8"])
def test_split_decode_matches_jax_kernel(fmt, ring, splits):
    q, pages, lengths, table, window, jpages = _case(fmt, ring, 7)
    sm_scale = D ** -0.5
    out, lse = tpf.fused_paged_decode_plain(
        q, pages, lengths, table, page_size=PS, sm_scale=sm_scale,
        window=window, splits=splits)
    live = lengths.numpy() > 0
    jout, jlse = jpf.fused_paged_decode_attention(
        jnp.asarray(q.float().numpy()[live], _JNP[q.dtype]), jpages,
        jnp.asarray(lengths.numpy()[live]), jnp.asarray(table.numpy()[live]),
        page_size=PS, window=window, interpret=True)
    atol = tolerance_for(q.dtype)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy()[live],
                               np.asarray(jout.astype(jnp.float32)),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(jlse),
                               atol=atol, rtol=1e-5)
    whole, whole_lse = tpf.fused_paged_decode_plain(
        q, pages, lengths, table, page_size=PS, sm_scale=sm_scale,
        window=window)
    assert bool((out[~torch.from_numpy(live)] == 0).all())
    assert torch.equal(lse[~torch.from_numpy(live)],
                       whole_lse[~torch.from_numpy(live)])
    if splits == 1:   # one split is the unsplit softmax, bit for bit
        assert torch.equal(out, whole) and torch.equal(lse, whole_lse)
    # some split of some sequence holds no live token
    per, n = tpf.decode_splits(P, PS, window, splits)
    split_of = tpf.token_splits(lengths, P, PS, window, per)
    _, valid = tpf.token_positions(lengths, P, PS, window)
    if n > 1:
        assert any(not bool((valid[b] & (split_of[b] == x)).any())
                   for b in range(B) for x in range(n))


@pytest.mark.parametrize("splits", [2, 7])
def test_split_separate_decode_matches_unsplit(splits):
    """B12's plain version over int8 pages with f32 scale pages: split and
    unsplit agree within the bf16 gate, lengths 0 and past the table
    included."""
    rng = np.random.default_rng(3)
    ps, n_pages = 128, B * 3 + 2
    q = torch.from_numpy(rng.standard_normal((B, HKV * GROUP, D)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (QuantizedTensor(
        torch.from_numpy(rng.integers(-127, 128, (HKV, n_pages, ps, D))
                         .astype(np.int8)),
        torch.from_numpy(rng.uniform(0.01, 0.02, (HKV, n_pages, ps, 1))
                         .astype(np.float32))) for _ in range(2))
    table = torch.from_numpy(
        rng.permutation(n_pages)[:B * 3].reshape(B, 3).astype(np.int32))
    lengths = torch.tensor([0, 1, 128, 300, 10**6], dtype=torch.int32)
    got = tpd.paged_decode_plain(q, k, v, lengths, table, sm_scale=D ** -0.5,
                                 splits=splits)
    want = tpd.paged_decode_plain(q, k, v, lengths, table,
                                  sm_scale=D ** -0.5)
    atol = tolerance_for(torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   atol=atol, rtol=1e-5)
    assert bool((got[0][0] == 0).all())


@pytest.mark.parametrize("pages,ps,window,splits", [
    (6, 16, None, 1), (6, 16, None, 4), (6, 16, None, 7),
    (32, 128, None, None), (64, 128, None, None), (4, 64, None, 3),
    (6, 16, 40, 2), (6, 16, 40, 7), (16, 128, 1024, None),
    (4, 64, 256, 3), (4, 64, 1, 2), (8, 32, 255, 5),
])
def test_split_plan_tiles_the_attended_tokens(pages, ps, window, splits):
    """Every attended token lies in exactly one split; a split's tokens are
    one run of positions that starts on a page edge (or at the first
    attended token) and ends on one (or at the last); runs follow in split
    order; no split spans more than its pages."""
    cap = pages * ps
    lengths = torch.tensor(sorted({0, 1, ps - 1, ps, ps + 1, cap // 2,
                                   cap - 1, cap, cap + 5, 3 * cap + 7}),
                           dtype=torch.int32)
    if window is None:
        lengths = lengths.clamp(max=cap + 5)
    per, n = tpf.decode_splits(pages, ps, window, splits)
    span = pages if window is None else configs.window_pages(window, ps)
    assert per * n >= span and per * (n - 1) < span
    pos, valid = tpf.token_positions(lengths, pages, ps, window)
    split_of = tpf.token_splits(lengths, pages, ps, window, per)
    for b in range(len(lengths)):
        toks = pos[b][valid[b]]
        mine = split_of[b][valid[b]]
        if toks.numel() == 0:
            continue
        assert bool(((mine >= 0) & (mine < n)).all())
        assert bool((mine[1:] >= mine[:-1]).all())   # in split order
        lo, hi = int(toks[0]), int(toks[-1]) + 1
        for x in mine.unique().tolist():
            run = toks[mine == x]
            a, z = int(run[0]), int(run[-1]) + 1
            assert torch.equal(run, torch.arange(a, z))
            assert a % ps == 0 or a == lo
            assert z % ps == 0 or z == hi
            assert -(-z // ps) - a // ps <= per


def test_default_split_is_fixed_in_tokens(monkeypatch):
    """A split holds PAGED_DECODE_SPLIT_TOKENS tokens of whole pages
    whatever the table's width, so the engine's bucketed (narrower) table
    and the full table give the same bits: the splits past a length add
    exact zeros to the merge (here at 2 pages a split: 2 and 3 splits)."""
    for ps in (16, 64, 128, 256):
        pers = {tpf.decode_splits(pages, ps)[0] for pages in (4, 8, 32, 64)}
        assert pers == {configs.paged_decode_split_pages(ps)}
    monkeypatch.setattr(configs, "PAGED_DECODE_SPLIT_TOKENS", 2 * PS)
    assert tpf.decode_splits(P, PS) == (2, 3)
    q, pages, lengths, table, _, _ = _case("int8", False, 11)
    lengths = torch.tensor([0, 1, PS, 3 * PS, 37], dtype=torch.int32)
    kw = dict(page_size=PS, sm_scale=D ** -0.5, splits="kernel")
    narrow = tpf.fused_paged_decode_plain(q, pages, lengths, table[:, :3],
                                          **kw)
    wide = tpf.fused_paged_decode_plain(q, pages, lengths, table, **kw)
    for a, b in zip(narrow, wide):
        assert torch.equal(a, b)
