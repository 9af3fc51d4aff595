"""Sharded serving of the port against the JAX package's, on the CPU.

The same weights (JAX's `init_params(CFG, key(0))`, carried over by
`params_from_jax`) and inputs go through JAX's `make_sharded_decode_loop`,
`ShardedInferenceEngine` and `spmd_forward` under `shard_map` on the
conftest's 8 virtual CPU devices (the Pallas decode in interpret mode) and
through the port's counterparts in one world of 8 gloo ranks on the CPU
(parallel/world.py; tests/torch_serve_ranks.py holds the rank functions,
which import torch only). The world runs every case once for the module,
on (1, 2), (2, 2) and (4, 2) meshes side by side, then packed (page, pow2)
and jagged admission on (1, 8), (2, 4) and (1, 1). Mirrors
tests/test_serve_sharded.py and tests/test_parallel_train.py::
test_spmd_forward_matches_single_device, and holds the sharded engine's
packed and jagged admission (the jagged mix of
tests/test_torch_ragged_admission.py) to JAX's ShardedInferenceEngine on
the 8 virtual devices and, on a (1, 1) mesh, to the port's single-card
engine bit for bit. Gates: f32 2e-5, bf16 2e-2 of the
largest magnitude, f32 pages at JAX's atol 1e-5, spmd logits at JAX's
atol 1e-3. Sampled streams are held against the port's single-card loop
and engine (torch does not reproduce jax.random).
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_serve_ranks as RK
from tiny_flash_attention_tpu.models import inference as JI
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.models.engine import InferenceEngine as JEngine
from tiny_flash_attention_tpu.models.engine import Request as JRequest
from tiny_flash_attention_tpu.models.kv_cache import PagedKVCache as JCache
from tiny_flash_attention_tpu.parallel import serve as JS
from tiny_flash_attention_tpu.parallel import train as JTR
from tiny_flash_attention_tpu.parallel.sharded import make_mesh as jax_mesh
from tiny_flash_attention_tpu_torch.models import inference as TI
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine as TEngine, Request)
from tiny_flash_attention_tpu_torch.models.kv_cache import (
    PagedKVCache as TCache)
from tiny_flash_attention_tpu_torch.ops.paged_fused import page_rows
from tiny_flash_attention_tpu_torch.parallel.train import (
    _local_cfg, param_specs)
from tiny_flash_attention_tpu_torch.parallel.world import run_world

from test_torch_quant_serving import _assert_int8_pages_near_jit

WORLD = 8
TIMEOUT_S = 240.0
SMALL = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)
PS = 128
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _models(dt="f32", **extra):
    jdt, tdt = _DT[dt]
    jcfg = JT.ModelConfig(**{**SMALL, **extra}, dtype=jdt, attn_impl="flash")
    tcfg = TT.ModelConfig(**{**SMALL, **extra}, dtype=tdt)
    jp = JT.init_params(jcfg, jax.random.key(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


# --- the decode-loop cases (JAX's test_sharded_decode_*) ---------------------
B, PPS, NUM_PAGES, STEPS = 2, 4, 16, 10


def _loop_inputs(tcfg, fmt, seed, pos0=(0, 0)):
    """Pages (random for pages of the model dtype, zeros for int8), the
    table of JAX's test, tokens, positions."""
    rows = page_rows(PS, tcfg.d_head, fmt)
    shape = (tcfg.n_kv_heads, NUM_PAGES, rows, tcfg.d_head)
    rng = np.random.default_rng(seed)
    if fmt == "int8":
        pages = [np.zeros(shape, np.int8) for _ in range(tcfg.n_layers)]
    else:
        pages = [rng.standard_normal(shape, dtype=np.float32)
                 for _ in range(tcfg.n_layers)]
    table = np.arange(B * PPS, dtype=np.int32).reshape(B, PPS) + 1
    return (pages, np.asarray([3, 77], np.int32),
            np.asarray(pos0, np.int32), table)


LOOPS = {
    # name: (dtype, fmt, extra config fields, greedy, temps, start positions)
    "f32 bf16 pages": ("f32", "bf16", {}, True, (0.0, 0.0), (0, 0)),
    "f32 int8 pages": ("f32", "int8", {}, True, (0.0, 0.0), (0, 0)),
    "bf16": ("bf16", "bf16", {}, True, (0.0, 0.0), (0, 0)),
    "window": ("f32", "bf16", {"attn_window": 256}, True, (0.0, 0.0),
               (505, 200)),
    "sampled": ("f32", "bf16", {}, False, (0.8, 1.3), (0, 0)),
}
LOOP_PAIRS = {"f32 bf16 pages": "pair0", "f32 int8 pages": "pair0",
              "bf16": "pair1", "window": "pair1", "sampled": "pair2"}


def _torch_pages(pages, tcfg, fmt):
    dtype = torch.int8 if fmt == "int8" else tcfg.dtype
    return [torch.from_numpy(p).to(dtype) for p in pages]


def _loop_job(name):
    dt, fmt, extra, greedy, temps, pos0 = LOOPS[name]
    _, _, tcfg, tp = _models(dt, **extra)
    pages, tok, pos, table = _loop_inputs(tcfg, fmt, 1, pos0)
    args = (tcfg, tp, _torch_pages(pages, tcfg, fmt), torch.from_numpy(tok),
            torch.from_numpy(pos), torch.from_numpy(table),
            torch.tensor(temps), 5)
    return (name, LOOP_PAIRS[name], "decode_loop_case", args,
            dict(fmt=fmt, n_steps=STEPS, greedy=greedy))


# --- the engine cases (JAX's test_sharded_engine_* / test_dp_tp_*) -----------
ENGINE_TP = dict(prompts=(31, (9, 40)), kw=dict(
    num_pages=32, page_size=PS, max_seqs=2, pages_per_seq=4), max_new=8)
ENGINE_DP = dict(prompts=(7, (9, 40, 130, 17)), kw=dict(
    num_pages=32, page_size=PS, max_seqs=4, pages_per_seq=4), max_new=6)


def _prompts(spec):
    rng = np.random.default_rng(spec[0])
    return [list(map(int, rng.integers(0, 256, size=n))) for n in spec[1]]


def _engine_job(name, mesh, spec, data_axis, temperature):
    _, _, tcfg, tp = _models()
    return (name, mesh, "engine_case", (tcfg, tp, _prompts(spec["prompts"])),
            dict(data_axis=data_axis, temperature=temperature,
                 max_new=spec["max_new"], chunk=spec["max_new"],
                 **spec["kw"]))


# --- packed and jagged admission (JAX's engine inherits both) --------------
# 16/8 heads so that the kv heads split over a model axis of 8; the jagged
# mix and engine geometry of tests/test_torch_ragged_admission.py
RAGGED_HEADS = dict(n_q_heads=16, n_kv_heads=8)
RAGGED_PROMPTS = (23, (7, 130, 61))
RAGGED_KW = dict(num_pages=64, page_size=PS, max_seqs=4, pages_per_seq=4)
RAGGED_NEW = 5
RAGGED_MODES = ("packed-page", "packed-pow2", "jagged")
RAGGED_MESHES = {"line": ((1, 8), None), "wide": ((2, 4), "data"),
                 "one": ((1, 1), None)}


def _ragged_jobs():
    _, _, tcfg, tp = _models(**RAGGED_HEADS)
    prompts = _prompts(RAGGED_PROMPTS)
    return [(f"ragged {mode} {name}", name, "ragged_engine_case",
             (tcfg, tp, prompts),
             dict(mode=mode, data_axis=data_axis, max_new=RAGGED_NEW,
                  **RAGGED_KW))
            for name, (_, data_axis) in RAGGED_MESHES.items()
            for mode in RAGGED_MODES]


def _admit_mode(eng, reqs, mode):
    if mode == "jagged":
        eng.add_requests_jagged(reqs)
    else:
        eng.add_requests_packed(reqs, pack_bucket=mode.split("-")[1])


SPMD_TOKENS = np.array(jax.random.randint(jax.random.key(1), (8, 64), 0,
                                          256), np.int32)
REDUCE_X = np.random.default_rng(3).standard_normal(4099).astype(np.float32)


def _jobs():
    _, _, tcfg, tp = _models()
    bad = dataclasses.replace(tcfg, n_q_heads=3, n_kv_heads=1)
    jobs = [_loop_job(name) for name in LOOPS]
    jobs += [_engine_job("engine tp", "pair3", ENGINE_TP, None, 0.0),
             ("refusals", "pair3", "refusals_case", (tcfg, tp), {}),
             _engine_job("engine dp greedy", "quad0", ENGINE_DP, "data",
                         0.0),
             _engine_job("engine dp sampled", "quad1", ENGINE_DP, "data",
                         0.9),
             ("spmd", "world", "spmd_case",
              (tcfg, tp, torch.from_numpy(SPMD_TOKENS)), {}),
             ("shards", "world", "shards_case", (tcfg, tp, bad), {}),
             ("all_reduce", "world", "all_reduce_case",
              (torch.from_numpy(REDUCE_X),), {})]
    return jobs + _ragged_jobs()


@pytest.fixture(scope="module")
def world():
    """Every rank's results, one world of 8 for the module."""
    return run_world(RK.run_jobs, WORLD, backend="gloo", device_type="cpu",
                     args=(_jobs(),), timeout_s=TIMEOUT_S)


def _ranks(world, name):
    return [(r, res[name]) for r, res in enumerate(world) if name in res]


def _pair_mesh():
    return Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ("data", "model"))


def _jax_loop(name, sharded: bool):
    dt, fmt, extra, greedy, temps, pos0 = LOOPS[name]
    jcfg, jp, tcfg, _ = _models(dt, **extra)
    pages, tok, pos, table = _loop_inputs(tcfg, fmt, 1, pos0)
    jpages = [jnp.asarray(p, jnp.int8 if fmt == "int8" else jcfg.dtype)
              for p in pages]
    args = (jp, jpages, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(table), jnp.asarray(temps, jnp.float32),
            jax.random.key(1))
    if sharded:
        loop = JS.make_sharded_decode_loop(jcfg, _pair_mesh(), page_size=PS,
                                           fmt=fmt, n_steps=STEPS,
                                           greedy=greedy)
        out_pages, sampled = loop(*args)
    else:
        out_pages, sampled, _ = JI.decode_loop(
            jcfg, *args, page_size=PS, fmt=fmt, n_steps=STEPS,
            greedy=greedy)
    return [np.asarray(p) for p in out_pages], np.asarray(sampled)


def _page_gate(got, want, dt):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    atol = 1e-5 if dt == "f32" else 2e-2 * float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= atol, f"pages: max abs err {err:.3e} > {atol:.3e}"


@pytest.mark.parametrize("name", ["f32 bf16 pages", "f32 int8 pages",
                                  "bf16", "window"])
def test_tp_decode_loop_matches_jax(world, name):
    """(1, 2) mesh, greedy: the tokens equal JAX's sharded loop and JAX's
    single-device decode_loop (the bf16 model: JAX's sharded loop), and
    each rank's local pages equal its kv head's slice of JAX's: f32 pages
    at atol 1e-5, bf16 pages at the bf16 gate, int8 pages byte for byte up
    to one level on at most 1e-4 of the payload (JAX's jitted writes),
    their scales at the f32 gate."""
    dt, fmt = LOOPS[name][:2]
    want_pages, want = _jax_loop(name, sharded=True)
    if dt == "f32":
        _, plain = _jax_loop(name, sharded=False)
        np.testing.assert_array_equal(want, plain)
    ranks = _ranks(world, name)
    assert len(ranks) == 2
    for model, (_, (sampled, pages)) in enumerate(ranks):
        np.testing.assert_array_equal(sampled.numpy(), want)
        for got, full in zip(pages, want_pages):
            mine = full[model:model + 1]
            if fmt == "int8":
                _assert_int8_pages_near_jit(got, mine, PS, scale_rtol=2e-5)
            else:
                _page_gate(got, mine, dt)


def test_sampled_tp_loop_matches_single_card(world):
    """Temperatures 0.8 and 1.3: every rank's stream equals the port's
    single-card decode_loop from the same generator state."""
    dt, fmt, extra, greedy, temps, pos0 = LOOPS["sampled"]
    _, _, tcfg, tp = _models(dt, **extra)
    pages, tok, pos, table = _loop_inputs(tcfg, fmt, 1, pos0)
    gen = torch.Generator().manual_seed(5)
    _, want, _ = TI.decode_loop(
        tcfg, tp, _torch_pages(pages, tcfg, fmt), torch.from_numpy(tok),
        torch.from_numpy(pos), torch.from_numpy(table), torch.tensor(temps),
        gen, page_size=PS, fmt=fmt, n_steps=STEPS, greedy=False)
    ranks = _ranks(world, "sampled")
    assert len(ranks) == 2
    for _, (sampled, _) in ranks:
        assert torch.equal(sampled, want)


def _jax_engines(spec, temperature, mesh, data_axis):
    jcfg, jp, _, _ = _models()
    prompts = _prompts(spec["prompts"])
    plain = JEngine(jcfg, jp, **spec["kw"])
    want = plain.generate(prompts, max_new_tokens=spec["max_new"],
                          temperature=temperature, chunk=spec["max_new"])
    sharded = JS.ShardedInferenceEngine(jcfg, jp, mesh, data_axis=data_axis,
                                        **spec["kw"])
    got = sharded.generate(prompts, max_new_tokens=spec["max_new"],
                           temperature=temperature, chunk=spec["max_new"])
    return want, got


def test_sharded_engine_generate_matches_jax(world):
    """ShardedInferenceEngine.generate on (1, 2): greedy tokens equal JAX's
    plain engine and JAX's ShardedInferenceEngine."""
    want, jax_sharded = _jax_engines(ENGINE_TP, 0.0, _pair_mesh(), None)
    assert jax_sharded == want
    ranks = _ranks(world, "engine tp")
    assert len(ranks) == 2
    for _, (got, n_groups, _, shape) in ranks:
        assert got == want
        assert n_groups == 1 and shape == (1, 32, 2 * PS, 128)


def test_dp_tp_engine_matches_jax_and_single_card(world):
    """(2, 2) mesh with data_axis="data": two page groups, a block of 16
    pages a rank, each group's first page its scratch page; greedy tokens
    equal JAX's (plain and sharded), and at temperature 0.9 every rank's
    tokens equal the port's single-card engine's."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    want, jax_sharded = _jax_engines(ENGINE_DP, 0.0, mesh, "data")
    assert jax_sharded == want
    _, _, tcfg, tp = _models()
    single = TEngine(tcfg, tp, **ENGINE_DP["kw"], device="cpu")
    sampled = single.generate(_prompts(ENGINE_DP["prompts"]),
                              max_new_tokens=ENGINE_DP["max_new"],
                              temperature=0.9, chunk=ENGINE_DP["max_new"])
    for name, expect in (("engine dp greedy", want),
                         ("engine dp sampled", sampled)):
        ranks = _ranks(world, name)
        assert len(ranks) == 4
        for _, (got, n_groups, free, shape) in ranks:
            assert got == expect, name
            assert n_groups == 2 and shape == (1, 16, 2 * PS, 128)
            assert free == [p for p in range(32) if p % 16]


def test_grouped_allocator_matches_jax():
    """n_groups=2 (JAX's test_grouped_allocator_partitions_pages): the
    port's and JAX's caches take the same alloc_slot / grow_slot /
    free_slot calls and end with equal page tables, free lists, lengths
    and counts; slots take pages of their own group only."""
    geom = dict(n_layers=1, n_kv_heads=1, num_pages=8, page_size=128,
                d_head=128, max_seqs=4, pages_per_seq=2, fmt="bf16",
                n_groups=2)
    caches = (TCache.create(**geom, device="cpu"), JCache.create(**geom))
    for c in caches:
        s0 = c.alloc_slot(256)
        assert c.group_of_slot(s0) == 0
        s1 = c.alloc_slot(256)
        s2 = c.alloc_slot(129)          # group 0 is full: group 1
        assert c.group_of_slot(s2) == 1
        assert all(4 <= p < 8 for p in c.page_table[s2, :2])
        c.free_slot(s0)
        s3 = c.alloc_slot(128)
        assert c.group_of_slot(s3) == 0
        c.grow_slot(s3, 256)
        c.grow_slot(s1, 256)            # covered already
        assert c.group_of_slot(c.alloc_slot(256)) == 1
    tc, jc = caches
    assert tc.page_table.tolist() == jc.page_table.tolist()
    assert tc.free_pages == jc.free_pages == []
    assert tc.lengths.tolist() == jc.lengths.tolist()
    assert tc.alloc_counts.tolist() == jc.alloc_counts.tolist()
    small = TCache.create(**{**geom, "pages_per_seq": 4}, device="cpu")
    a = small.alloc_slot(256)
    small.alloc_slot(256)               # group 0's pages are gone
    with pytest.raises(RuntimeError, match="in data group 0"):
        small.grow_slot(a, 384)
    assert small.group_of_slot(small.alloc_slot(512)) == 1
    with pytest.raises(RuntimeError, match="every data group"):
        small.alloc_slot(1)
    with pytest.raises(ValueError):
        TCache.create(**{**geom, "num_pages": 9}, device="cpu")


def test_grouped_cache_held_block_writes():
    """A rank holding group 1's block (held_group=1) gets a page tensor of
    num_pages / n_groups pages; prefill and append write its own group's
    slots at global id - 4 and skip group 0's; it equals the slice of a
    whole-pool cache that took the same writes."""
    geom = dict(n_layers=1, n_kv_heads=2, num_pages=8, page_size=16,
                d_head=64, max_seqs=4, pages_per_seq=2, n_groups=2,
                dtype=torch.float32, device="cpu")
    whole = TCache.create(**geom)
    held = TCache.create(**geom, held_group=1)
    assert held.pages[0].shape[1] == 4 and held.num_pages == 8
    rng = np.random.default_rng(4)
    for c in (whole, held):
        slots = np.asarray([c.alloc_slot(20), c.alloc_slot(30),
                            c.alloc_slot(17)])
    assert [whole.group_of_slot(int(s)) for s in slots] == [0, 0, 1]
    for s in slots:
        k = torch.from_numpy(rng.standard_normal((1, 2, 32, 64),
                                                 dtype=np.float32))
        for c in (whole, held):
            c.write_prefill(int(s), k, -k)
            c.lengths[s] = 20
    k = torch.from_numpy(rng.standard_normal((1, 2, 3, 64),
                                             dtype=np.float32))
    for c in (whole, held):
        c.append_tokens(slots, k, 2 * k)
    assert torch.equal(held.pages[0], whole.pages[0][:, 4:])
    assert held.lengths.tolist() == whole.lengths.tolist() == [21, 21, 21, 0]
    with pytest.raises(ValueError, match="block"):
        held.save("unused.npz")


def test_held_block_reads_and_writes_map_ids_alike():
    """The cache's writes (PagedKVCache.local_ids) and the sharded decode's
    reads (serve._local_inputs) map global page ids into a group's block
    by one function: group 1's ids at id - 4; freed and idle entries
    (global 0) and lower ids clip onto its scratch page, its block's
    first, never out of it; a whole-pool cache keeps the ids."""
    from tiny_flash_attention_tpu_torch.parallel import serve as TS

    geom = dict(n_layers=1, n_kv_heads=1, num_pages=8, page_size=16,
                d_head=64, max_seqs=4, pages_per_seq=2, n_groups=2,
                dtype=torch.float32, device="cpu")
    held = TCache.create(**geom, held_group=1)
    ids = np.asarray([4, 5, 7, 0, 3], np.int32)
    assert held.local_ids(ids).tolist() == [0, 1, 3, 0, 0]
    assert TCache.create(**geom).local_ids(ids).tolist() == ids.tolist()
    table = torch.tensor([[1, 2], [3, 0], [5, 6], [7, 0]], dtype=torch.int32)
    place = TS._Place(tp=1, model_group=None, dp=2, group=1,
                      data_group=None)
    zeros = torch.zeros(4, dtype=torch.int32)
    _, _, local, rows = TS._local_inputs(place, held.pages, zeros, zeros,
                                         table, True)
    assert rows == slice(2, 4)
    assert torch.equal(local, held.local_ids(table[2:]))
    assert local.tolist() == [[1, 2], [3, 0]]


def test_jax_cache_with_groups_loads(tmp_path):
    """A JAX cache saved with n_groups=2 loads into the port with the same
    host state and pages, and keeps allocating within its groups."""
    geom = dict(n_layers=2, n_kv_heads=2, num_pages=12, page_size=16,
                d_head=64, max_seqs=4, pages_per_seq=4)
    jc = JCache.create(**geom, dtype=jnp.bfloat16, n_groups=2)
    rng = np.random.default_rng(2)
    for n in (40, 20, 33):
        slot = jc.alloc_slot(n)
        k = rng.standard_normal((2, 2, 48 if n > 32 else 32, 64)).astype(
            np.float32)
        jc.write_prefill(slot, jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(-k, jnp.bfloat16))
        jc.lengths[slot] = n
    jc.save(str(tmp_path / "groups.npz"))
    tc = TCache.load(str(tmp_path / "groups.npz"), device="cpu")
    assert tc.n_groups == 2 and tc.num_pages == 12
    assert tc.page_table.tolist() == jc.page_table.tolist()
    assert [int(p) for p in jc.free_pages] == tc.free_pages
    assert tc.lengths.tolist() == jc.lengths.tolist()
    assert tc.alloc_counts.tolist() == jc.alloc_counts.tolist()
    for got, want in zip(tc.pages, jc.pages):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    jc.free_slot(0)
    tc.free_slot(0)
    assert tc.alloc_slot(16) == jc.alloc_slot(16)
    assert tc.page_table.tolist() == jc.page_table.tolist()
    tc.save(str(tmp_path / "back.npz"))
    assert JCache.load(str(tmp_path / "back.npz")).n_groups == 2


def test_spmd_forward_matches_jax(world):
    """spmd_forward on a (4, 2) mesh, each data row of ranks taking two of
    the 8 sequences: the logits equal JAX's spmd_forward under shard_map
    and JAX's single-device forward at atol 1e-3 (the JAX test's gate),
    the same on both ranks of a model group."""
    jcfg, jp, _, _ = _models()
    jcfg = dataclasses.replace(jcfg, attn_impl="reference")
    mesh = jax_mesh(8, data=4, model=2)
    toks = jnp.asarray(SPMD_TOKENS)
    fwd = jax.jit(jax.shard_map(
        lambda p, t: JTR.spmd_forward(JTR._local_cfg(jcfg, 2), p, t),
        mesh=mesh, in_specs=(JTR.param_specs(jcfg), P("data", None)),
        out_specs=P("data", None), check_vma=False))
    want = np.asarray(fwd(JTR.shard_params(jp, mesh, jcfg), toks))
    np.testing.assert_allclose(want, np.asarray(JT.forward(jcfg, jp, toks)),
                               atol=1e-3, rtol=0)
    ranks = _ranks(world, "spmd")
    assert len(ranks) == WORLD
    for rank, logits in ranks:
        g = rank // 2
        np.testing.assert_allclose(logits.numpy(), want[2 * g:2 * g + 2],
                                   atol=1e-3, rtol=0)
        assert torch.equal(logits, ranks[rank ^ 1][1])


def test_shard_params_reassemble(world):
    """The model axis's shards put back together along their param_specs
    dimension give the full params, bit for bit; the replicated leaves are
    whole on every rank; heads that do not split over the model axis
    raise ValueError, in shard_params and in _local_cfg."""
    _, _, tcfg, tp = _models()
    specs = param_specs(tcfg)
    ranks = _ranks(world, "shards")
    assert len(ranks) == WORLD
    for data_row in range(4):
        pair = [ranks[2 * data_row + m][1] for m in range(2)]
        assert [r["model"] for r in pair] == [0, 1]
        for key in ("embed", "final_norm", "lm_head"):
            for r in pair:
                assert torch.equal(r["local"][key], tp[key])
        for li, spec in enumerate(specs["layers"]):
            for key, dim in spec.items():
                parts = [r["local"]["layers"][li][key] for r in pair]
                whole = tp["layers"][li][key]
                if dim is None:
                    assert all(torch.equal(p, whole) for p in parts)
                else:
                    assert parts[0].shape[dim] * 2 == whole.shape[dim]
                    assert torch.equal(torch.cat(parts, dim), whole)
        assert all("not divisible" in r["refused"] for r in pair)
    with pytest.raises(ValueError, match="not divisible"):
        _local_cfg(tcfg, 4)


def test_all_reduce_same_bits_on_every_rank(world):
    """comm.all_reduce over groups of 2, 4 and 8 ranks: every rank of a
    group gets the same bits, the sum of the ranks' inputs (to f32
    rounding), and the input is left as it was; its gradient (psum's
    transpose) is the identity: each rank's input gets the cotangent of
    the sum, the same bits on every rank."""
    ranks = _ranks(world, "all_reduce")
    assert len(ranks) == WORLD
    groups = ([[2 * i, 2 * i + 1] for i in range(4)],
              [[m, m + 2, m + 4, m + 6] for m in range(2)],
              [list(range(WORLD))])
    for which, members in enumerate(groups):
        for group in members:
            bits = [ranks[r][1]["sums"][which] for r in group]
            assert all(torch.equal(b, bits[0]) for b in bits)
            want = sum(REDUCE_X.astype(np.float64) + r for r in group)
            np.testing.assert_allclose(bits[0].view(torch.float32).numpy(),
                                       want, rtol=1e-6, atol=1e-5)
    assert all(r["grad_is_identity"] for _, r in ranks)
    assert all(torch.equal(r["grad"], ranks[0][1]["grad"]) for _, r in ranks)


def test_sharded_engine_refusals(world):
    """Quantized weights raise ValueError, as JAX's param_specs does; the
    loop and the engine run on the card unless given device="cpu"."""
    ranks = _ranks(world, "refusals")
    assert len(ranks) == 2
    for _, refused in ranks:
        assert set(refused) == {"quantized", "loop on the card",
                                "engine on the card"}


@functools.lru_cache(maxsize=None)
def _jax_ragged(mode, shape, data_axis):
    """JAX's ShardedInferenceEngine on a (data, model) mesh of the virtual
    devices (shape None: JAX's single-chip engine) admitting the jagged
    mix by `mode`: (greedy tokens, the page table and the global pages
    after the admission)."""
    jcfg, jp, _, _ = _models(**RAGGED_HEADS)
    if shape is None:
        eng = JEngine(jcfg, jp, **RAGGED_KW)
    else:
        n = shape[0] * shape[1]
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        eng = JS.ShardedInferenceEngine(jcfg, jp, mesh, data_axis=data_axis,
                                        **RAGGED_KW)
    reqs = [JRequest(list(p), max_new_tokens=RAGGED_NEW)
            for p in _prompts(RAGGED_PROMPTS)]
    _admit_mode(eng, reqs, mode)
    table = eng.cache.page_table.copy()
    pages = [np.asarray(p) for p in eng.cache.pages]
    eng.steps(RAGGED_NEW - 1)
    return [r.generated for r in reqs], table, pages


@pytest.mark.parametrize("mesh_name", ["line", "wide"])
@pytest.mark.parametrize("mode", RAGGED_MODES)
def test_sharded_ragged_admission_matches_jax(world, mode, mesh_name):
    """Packed (page, pow2) and jagged admission on (1, 8) and on (2, 4)
    with page groups: every rank's greedy tokens and page table equal JAX's
    ShardedInferenceEngine's on the same mesh (itself JAX's single-chip
    engine's), and each rank's pages after the admission, its kv heads of
    its data group's block, equal JAX's slice on the rows below each
    length at the fp32 gate (2e-5)."""
    shape, data_axis = RAGGED_MESHES[mesh_name]
    want, table, jpages = _jax_ragged(mode, shape, data_axis)
    assert want == _jax_ragged(mode, None, None)[0]
    dp, tp = shape
    hl, p_local = 8 // tp, RAGGED_KW["num_pages"] // dp
    prompts = _prompts(RAGGED_PROMPTS)
    ranks = _ranks(world, f"ragged {mode} {mesh_name}")
    assert len(ranks) == dp * tp
    for _, r in ranks:
        assert r["tokens"] == want and r["n_groups"] == dp
        np.testing.assert_array_equal(r["table"].numpy(), table)
        m, g = r["model"], r["group"]
        compared = 0
        for li, pages in enumerate(r["pages"]):
            assert tuple(pages.shape) == (hl, p_local, 2 * PS, 128)
            full = jpages[li][m * hl:(m + 1) * hl,
                              g * p_local:(g + 1) * p_local]
            for slot, prompt in zip(r["slots"], prompts):
                if slot // (RAGGED_KW["max_seqs"] // dp) != g:
                    continue
                L = len(prompt)
                ids = table[slot, :-(-L // PS)] - g * p_local
                got = pages[:, ids].reshape(hl, -1, 2, PS, 128).numpy()
                ref = full[:, ids].reshape(hl, -1, 2, PS, 128)
                for half in range(2):               # K rows, V rows
                    np.testing.assert_allclose(
                        got[:, :, half].reshape(hl, -1, 128)[:, :L],
                        ref[:, :, half].reshape(hl, -1, 128)[:, :L],
                        atol=2e-5, rtol=0)
                compared += 1
        assert compared > 0


@contextlib.contextmanager
def _rank_threads():
    """torch's threads as a rank of the world has them (parallel/world.py),
    so that the CPU products round as the rank's do."""
    keep = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))
    try:
        yield
    finally:
        torch.set_num_threads(keep)


@pytest.mark.parametrize("mode", RAGGED_MODES)
def test_sharded_ragged_admission_one_rank_bits(world, mode):
    """On a (1, 1) mesh the sharded engine's packed and jagged admission
    give the port's single-card engine's tokens, page table and pages bit
    for bit (an axis of one rank makes no collective)."""
    _, _, tcfg, tp = _models(**RAGGED_HEADS)
    with _rank_threads():
        single = TEngine(tcfg, tp, **RAGGED_KW, device="cpu")
        reqs = [Request(list(p), RAGGED_NEW)
                for p in _prompts(RAGGED_PROMPTS)]
        _admit_mode(single, reqs, mode)
        pages = [p.clone() for p in single.cache.pages]
        table = single.cache.page_table.copy()
        single.steps(RAGGED_NEW - 1)
    ranks = _ranks(world, f"ragged {mode} one")
    assert len(ranks) == 1
    got = ranks[0][1]
    assert got["tokens"] == [r.generated for r in reqs]
    np.testing.assert_array_equal(got["table"].numpy(), table)
    assert all(torch.equal(a, b) for a, b in zip(got["pages"], pages))
