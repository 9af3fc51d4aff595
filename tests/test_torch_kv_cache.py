"""The port's PagedKVCache against the JAX package's, on the CPU: the same
allocator decisions, byte-identical pages after the same writes, and
save/load across the two packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu.models.kv_cache import PagedKVCache as JCache
from tiny_flash_attention_tpu_torch.models.kv_cache import (
    PagedKVCache as TCache)

GEOM = dict(n_layers=2, n_kv_heads=2, num_pages=12, page_size=16, d_head=64,
            max_seqs=3, pages_per_seq=4)


def _pair():
    return (TCache.create(**GEOM, dtype=torch.bfloat16, device="cpu"),
            JCache.create(**GEOM, dtype=jnp.bfloat16))


def _host_state(c):
    return (c.page_table.tolist(), c.lengths.tolist(), list(c.free_pages),
            c.alloc_counts.tolist())


def _page_bits(c):
    out = []
    for p in c.pages:
        if isinstance(p, torch.Tensor):
            out.append(p.contiguous().view(torch.int16).numpy())
        else:
            out.append(np.asarray(p).view(np.int16))
    return out


def _assert_pages_equal(tc, jc):
    for got, want in zip(_page_bits(tc), _page_bits(jc)):
        np.testing.assert_array_equal(got, want)


def test_allocator_matches_jax():
    tc, jc = _pair()
    for c in (tc, jc):
        a = c.alloc_slot(20)          # 2 pages
        b = c.alloc_slot(64)          # 4 pages
        c.grow_slot(a, 40)            # +1 page
        c.free_slot(b)
        c.alloc_slot(1)
        c.grow_slot(a, 40)            # already covered: no change
    assert _host_state(tc) == _host_state(jc)
    assert tc.lengths.tolist() == [-1, -1, 0]
    with pytest.raises(ValueError):
        tc.alloc_slot(GEOM["page_size"] * GEOM["pages_per_seq"] + 1)


@pytest.mark.parametrize("n_groups", [1, 3])
def test_allocator_churn_matches_jax(n_groups):
    """A seeded run of alloc_slot / grow_slot / free_slot calls on one pool
    and on three groups, each group's pages enough for its slots' whole
    tables: the port's caches take JAX's decisions, call for call (which
    pages each pop takes, in which order)."""
    geom = dict(GEOM, num_pages=24, max_seqs=6, n_groups=n_groups)
    tc = TCache.create(**geom, dtype=torch.bfloat16, device="cpu")
    jc = JCache.create(**geom, dtype=jnp.bfloat16)
    rng = np.random.default_rng(n_groups)
    ops = set()
    for _ in range(60):
        held = np.flatnonzero(tc.lengths != 0)
        op = int(rng.integers(3))
        if op == 0 and held.size < geom["max_seqs"]:
            n = int(rng.integers(1, 3 * GEOM["page_size"]))
            assert tc.alloc_slot(n) == jc.alloc_slot(n)
        elif op == 1 and held.size:
            s = int(rng.choice(held))
            n = int(rng.integers(1, GEOM["page_size"] * GEOM["pages_per_seq"]
                                 + 1))
            for c in (tc, jc):
                c.grow_slot(s, n)
        elif held.size:
            s = int(rng.choice(held))
            for c in (tc, jc):
                c.free_slot(s)
        else:
            continue
        ops.add(op)
        assert _host_state(tc) == _host_state(jc)
    assert ops == {0, 1, 2}


def test_allocator_exhaustion_raises():
    tc, _ = _pair()
    for _ in range(GEOM["max_seqs"]):
        tc.alloc_slot(1)
    with pytest.raises(RuntimeError, match="slots"):
        tc.alloc_slot(1)
    small = TCache.create(**{**GEOM, "num_pages": 3}, device="cpu")
    with pytest.raises(RuntimeError, match="pages"):
        small.alloc_slot(4 * GEOM["page_size"])
    slot = small.alloc_slot(2 * GEOM["page_size"])
    with pytest.raises(RuntimeError, match="pages"):
        small.grow_slot(slot, 4 * GEOM["page_size"])


def test_writes_byte_identical_to_jax():
    """write_prefill then two rounds of append_tokens; pages compared as
    16-bit integers, the host state as lists."""
    rng = np.random.default_rng(0)
    nl, hkv, d, ps = GEOM["n_layers"], GEOM["n_kv_heads"], 64, 16
    tc, jc = _pair()
    slots = np.array([tc.alloc_slot(40), tc.alloc_slot(20)])
    for s in slots:
        assert jc.alloc_slot(40 if s == slots[0] else 20) == s
    for slot, L in zip(slots, (32, 16)):
        k = rng.standard_normal((nl, hkv, L, d)).astype(np.float32)
        v = rng.standard_normal((nl, hkv, L, d)).astype(np.float32)
        tc.write_prefill(int(slot), torch.from_numpy(k).bfloat16(),
                         torch.from_numpy(v).bfloat16())
        jc.write_prefill(int(slot), jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16))
        tc.lengths[slot] = jc.lengths[slot] = L - 3
    for _ in range(2):
        k = rng.standard_normal((nl, hkv, 2, d)).astype(np.float32)
        v = rng.standard_normal((nl, hkv, 2, d)).astype(np.float32)
        tc.append_tokens(slots, torch.from_numpy(k), torch.from_numpy(v))
        jc.append_tokens(slots, jnp.asarray(k), jnp.asarray(v))
    assert _host_state(tc) == _host_state(jc)
    _assert_pages_equal(tc, jc)
    pt, ln = tc.device_views()
    assert pt.dtype == torch.int32 and ln.tolist() == [31, 15, 0]


def test_save_load_roundtrip_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    tc, jc = _pair()
    for c in (tc, jc):
        c.alloc_slot(30)
    k = rng.standard_normal((2, 2, 32, 64)).astype(np.float32)
    tc.write_prefill(0, torch.from_numpy(k).bfloat16(),
                     torch.from_numpy(-k).bfloat16())
    jc.write_prefill(0, jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(-k, jnp.bfloat16))
    tc.lengths[0] = jc.lengths[0] = 30
    tc.save(str(tmp_path / "t.npz"))
    jc.save(str(tmp_path / "j.npz"))
    for back in (TCache.load(str(tmp_path / "t.npz"), device="cpu"),
                 TCache.load(str(tmp_path / "j.npz"), device="cpu")):
        assert back.pages[0].dtype == torch.bfloat16
        assert _host_state(back) == _host_state(tc)
        _assert_pages_equal(back, jc)
    jback = JCache.load(str(tmp_path / "t.npz"))
    assert _host_state(jback) == _host_state(jc)
    _assert_pages_equal(tc, jback)


def test_formats_not_ported_raise(tmp_path):
    """int8 pages are ported; an unknown format is refused. A cache saved
    with data-parallel page groups (n_groups > 1) loads with its groups."""
    with pytest.raises(ValueError):
        TCache.create(**GEOM, fmt="fp8", device="cpu")
    jc = JCache.create(**{**GEOM, "max_seqs": 4}, dtype=jnp.bfloat16,
                       n_groups=2)
    jc.alloc_slot(40)
    jc.save(str(tmp_path / "groups.npz"))
    back = TCache.load(str(tmp_path / "groups.npz"), device="cpu")
    assert back.n_groups == 2 and _host_state(back) == _host_state(jc)
    _assert_pages_equal(back, jc)
