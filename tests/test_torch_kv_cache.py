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
    """int8 pages are ported; an unknown format is refused, and a cache
    saved with data-parallel page groups (n_groups > 1) is not ported."""
    with pytest.raises(ValueError):
        TCache.create(**GEOM, fmt="fp8", device="cpu")
    jc = JCache.create(**{**GEOM, "max_seqs": 4}, dtype=jnp.bfloat16,
                       n_groups=2)
    jc.save(str(tmp_path / "groups.npz"))
    with pytest.raises(NotImplementedError, match="groups"):
        TCache.load(str(tmp_path / "groups.npz"), device="cpu")
