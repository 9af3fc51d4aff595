"""The port's sharded train step against the JAX package's, on the CPU.

The same weights (JAX's `init_params`, carried over by `params_from_jax`)
and token batches go through JAX's `make_train_step` on (data, model)
meshes of the conftest's 8 virtual CPU devices (GSPMD, the attention in
its shard_map island) and through the port's `make_train_step` on
DeviceMeshes of one world of 8 gloo ranks on the CPU (parallel/world.py;
tests/torch_train_ranks.py holds the rank functions, which import torch
only). The world runs every case once for the module, on the (4, 2) and
(8, 1) meshes side by side. Mirrors tests/test_parallel_train.py. The
model is the JAX test's (vocab 128, d_model 128, 2 layers, 4/2 heads of
128, d_ff 256, f32, tokens (8, 64)), with attn_impl="reference" and
"flash" (JAX's flash at 64 tokens takes its plain-XLA path, the port's its
plain versions on the CPU). Gates: the loss within 1e-5 and every leaf
within 2e-5 after one SGD step (JAX's test checks five leaves), AdamW
losses within 1e-4, a resumed checkpoint's loss exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_train_ranks as RK
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.parallel import train as JTR
from tiny_flash_attention_tpu.parallel.sharded import make_mesh as jax_mesh
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.parallel.multihost import (
    _hybrid_rank_array)
from tiny_flash_attention_tpu_torch.parallel.train import (
    param_leaves, param_specs)
from tiny_flash_attention_tpu_torch.parallel.world import run_world

from test_torch_train import _jax_leaves

WORLD = 8
TIMEOUT_S = 240.0
SMALL = dict(vocab_size=128, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)
LR = 1e-2
# name: (attn_impl, attn_window, mesh)
SGD_CASES = {"reference (4, 2)": ("reference", None, "4x2"),
             "flash (4, 2)": ("flash", None, "4x2"),
             "flash window 16 (4, 2)": ("flash", 16, "4x2"),
             "reference (8, 1)": ("reference", None, "8x1")}


def _models(impl="reference", window=None, seed=0):
    fields = dict(SMALL, attn_impl=impl, attn_window=window)
    jcfg = JT.ModelConfig(**fields, dtype=jnp.float32)
    tcfg = TT.ModelConfig(**fields, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu")


def _tokens(seed):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (8, 64)).astype(np.int32)


ADAMW_BATCHES = [_tokens(10 + i) for i in range(3)]
CKPT_BATCHES = [_tokens(30 + i) for i in range(3)]


def _jobs(ck_path):
    jobs = []
    for name, (impl, window, mesh) in SGD_CASES.items():
        _, _, tcfg, tp = _models(impl, window)
        jobs.append((name, "sgd_case", (mesh, tcfg, tp,
                                        torch.from_numpy(_tokens(2)))))
    _, _, tcfg, tp3 = _models(seed=3)
    tp5, tp99 = _models(seed=5)[3], _models(seed=99)[3]
    bad = dataclasses.replace(tcfg, n_q_heads=3, n_kv_heads=1)
    jobs += [("adamw", "adamw_case",
              ("4x2", tcfg, tp3, [torch.from_numpy(t)
                                  for t in ADAMW_BATCHES])),
             ("checkpoint", "checkpoint_case",
              (tcfg, tp5, tp99, [torch.from_numpy(t) for t in CKPT_BATCHES],
               ck_path)),
             ("hybrid", "hybrid_case", ()),
             ("refusals", "refusals_case", (tcfg, tp3, bad))]
    return jobs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results, one world of 8 for the module."""
    ck = str(tmp_path_factory.mktemp("sharded_ckpt") / "ck")
    return run_world(RK.run_jobs, WORLD, backend="gloo", device_type="cpu",
                     args=(_jobs(ck),), timeout_s=TIMEOUT_S)


def _blocks(leaves: list, model: int, tp: int) -> list:
    """Rank `model`'s blocks of global leaves (param_leaves order) along
    their param_specs dimensions."""
    dims = param_leaves(param_specs(TT.ModelConfig(**SMALL)))
    return [w if d is None else np.split(w, tp, axis=d)[model]
            for w, d in zip(leaves, dims)]


def _assert_rank_leaves(got: list, want: list, atol: float, what: str):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= atol, f"{what}, leaf {i}: max abs err {err:.3e}"


def _assert_rank_updates(got: list, want: list, before: list, what: str):
    """Each leaf's update (after - before, the step's gradient times -lr)
    within a relative Frobenius distance of 1e-3 of JAX's: a gradient
    that lost part of a sum moves it by tenths where the absolute leaf
    gate sees ~2e-5."""
    for i, (g, w, b) in enumerate(zip(got, want, before)):
        dg, dw = g.numpy().astype(np.float64) - b, w.astype(np.float64) - b
        err = np.linalg.norm(dg - dw) / max(np.linalg.norm(dw), 1e-30)
        assert err <= 1e-3, f"{what}, leaf {i}: update off by {err:.3e}"


def _jax_sgd(jcfg, jp, toks, shape):
    """(single-device loss and leaves, sharded loss and leaves) of one
    SGD step in JAX."""
    opt = optax.sgd(LR)
    loss, grads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jnp.asarray(toks)))(jp)
    updates, _ = opt.update(grads, opt.init(jp), jp)
    single = (float(loss), _jax_leaves(optax.apply_updates(jp, updates)))
    step, init = JTR.make_train_step(jcfg, jax_mesh(8, *shape),
                                     optimizer=optax.sgd(LR))
    new, _, sloss = step(*init(jp), jnp.asarray(toks))
    return single, (float(sloss), _jax_leaves(new))


@pytest.mark.parametrize("name", list(SGD_CASES))
def test_sgd_step_matches_jax(world, name):
    """One SGD(1e-2) step on the mesh: every rank's loss within 1e-5 of
    JAX's sharded step's and of its single-device step's, and every one
    of its leaves (the replicated embed, norms and lm_head, which f's and
    g's placement decides, and its blocks of the cut ones) within 2e-5 of
    the matching block of both; each leaf's update within 1e-3 of both
    in relative Frobenius distance."""
    impl, window, mesh = SGD_CASES[name]
    jcfg, jp, _, _ = _models(impl, window)
    shape = RK.MESHES[mesh]
    before = _jax_leaves(jp)       # before the sharded step donates jp
    single, sharded = _jax_sgd(jcfg, jp, _tokens(2), shape)
    np.testing.assert_allclose(sharded[0], single[0], rtol=0, atol=1e-5)
    assert len(world) == WORLD
    for rank, res in enumerate(world):
        got = res[name]
        assert got["model"] == rank % shape[1]
        assert got["loss"].dtype == torch.float32 and got["loss"].dim() == 0
        for what, (loss, leaves) in (("JAX sharded", sharded),
                                     ("JAX single device", single)):
            np.testing.assert_allclose(float(got["loss"]), loss, rtol=0,
                                       atol=1e-5)
            want = _blocks(leaves, got["model"], shape[1])
            _assert_rank_leaves(got["leaves"], want, 2e-5,
                                f"{name} rank {rank} vs {what}")
            _assert_rank_updates(got["leaves"], want,
                                 _blocks(before, got["model"], shape[1]),
                                 f"{name} rank {rank} vs {what}")
        # the global loss and the replicated leaves: one value everywhere
        assert torch.equal(got["loss"], world[0][name]["loss"])


def test_adamw_steps_match_jax_and_fall(world):
    """Three steps of the default AdamW on (4, 2), a fresh batch each:
    the losses are finite, fall, are the same bits on every rank and are
    within 1e-4 of JAX's sharded AdamW step's."""
    jcfg, jp, _, _ = _models(seed=3)
    step, init = JTR.make_train_step(jcfg, jax_mesh(8, 4, 2))
    state = init(jp)
    want = []
    for toks in ADAMW_BATCHES:
        *state, loss = step(*state, jnp.asarray(toks))
        want.append(float(loss))
    for res in world:
        got = [float(x) for x in res["adamw"]]
        assert all(np.isfinite(got)) and got[-1] < got[0], got
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert got == [float(x) for x in world[0]["adamw"]]


def test_checkpoint_resumes_to_the_same_loss(world):
    """Saved after two AdamW steps on (4, 2): restored onto (4, 2), the
    third step's loss equals the uninterrupted run's exactly and the
    restored leaves are the param_specs blocks of the saved global ones
    (the uninterrupted run's leaves, gathered, hold them: each rank's
    restored blocks equal those its neighbours restored together with
    it); restored onto (8, 1), the loss is within 1e-5."""
    for res in world:
        ck = res["checkpoint"]
        assert ck["4x2"]["step"] == ck["8x1"]["step"] == 2
        assert float(ck["4x2"]["loss"]) == float(ck["cont"])
        np.testing.assert_allclose(float(ck["8x1"]["loss"]),
                                   float(ck["cont"]), rtol=0, atol=1e-5)
    # the (8, 1) restore holds the global leaves on every rank; each (4, 2)
    # rank's restored leaves are their blocks
    whole = [t.numpy() for t in world[0]["checkpoint"]["8x1"]["restored"]]
    for res in world:
        ck = res["checkpoint"]
        got = ck["4x2"]["restored"]
        want = _blocks(whole, ck["model"], 2)
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
        assert all(np.array_equal(g.numpy(), w) for g, w in
                   zip(ck["8x1"]["restored"], whole))


def test_hybrid_mesh_single_host(world):
    """initialize_multihost() is a no-op without a coordinator;
    make_hybrid_mesh(("model", "seq"), (4, 2)) over one host's 8 ranks is
    {data: 1, model: 4, seq: 2}, and a sum over 'model' of arange(8)'s
    blocks is the total."""
    for res in world:
        assert res["hybrid"]["sizes"] == {"data": 1, "model": 4, "seq": 2}
        assert float(res["hybrid"]["total"]) == 28.0


def test_hybrid_rank_array():
    """Hosts [0]*4 + [1]*4, ici_shape (2, 2), two slices: shape (2, 2, 2),
    each block one host's ranks (also with the hosts interleaved); one
    slice keeps a leading axis of size 1."""
    arr = _hybrid_rank_array([0, 0, 0, 0, 1, 1, 1, 1], [2, 2], 2)
    assert tuple(arr.shape) == (2, 2, 2)
    assert arr.tolist() == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    hosts = ["b", "a"] * 4
    arr = _hybrid_rank_array(hosts, [2, 2], 2)
    for s in range(2):
        assert {hosts[r] for r in arr[s].flatten().tolist()} == {"ba"[s]}
    assert tuple(_hybrid_rank_array(hosts, [8], 1).shape) == (1, 8)
    # one machine standing for two hosts: contiguous blocks
    assert _hybrid_rank_array([0] * 4, [2], 2).tolist() == [[0, 1], [2, 3]]
    with pytest.raises(ValueError):
        _hybrid_rank_array([0, 0, 0, 1], [2], 2)


def test_refusals(world):
    """A global batch that does not split over 'data', quantized weights
    and heads that do not split over 'model' raise ValueError."""
    for res in world:
        refused = res["refusals"]
        assert set(refused) == {"batch", "quantized", "heads"}
        assert "split over data" in refused["batch"]
        assert "quantized" in refused["quantized"]
        assert "not divisible" in refused["heads"]
