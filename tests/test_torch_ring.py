"""Context-parallel attention of the port against the JAX package's.

The same numpy inputs go through JAX's ring, zigzag ring, Ulysses,
all-gather and head-sharded attention under `shard_map` on the conftest's 8
virtual CPU devices, and through the port's counterparts in a world of
gloo ranks on the CPU (parallel/world.py). One world of 8 runs every case
once for the module (tests/torch_parallel_ranks.py holds the rank
functions: the ranks import torch only); the tests read its results. The
mirrored cases are tests/test_ring.py's and tests/test_ring_overlap.py's
two properties, plus GQA, bf16 and the gradients of each mode against
`jax.grad`. Gates: f32 2e-5, bf16 2e-2 (the JAX tests' dtype gates), the
gradients 1e-3 (tests/test_ring.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_ranks as RK
from tiny_flash_attention_tpu.ops.configs import FlashConfig
from tiny_flash_attention_tpu.parallel import ring as JR
from tiny_flash_attention_tpu.parallel import sharded as JS
from tiny_flash_attention_tpu_torch.parallel import ring as TR
from tiny_flash_attention_tpu_torch.parallel.sharded import mesh_shape
from tiny_flash_attention_tpu_torch.parallel.world import run_world

WORLD = 8
TIMEOUT_S = 240.0
CTX4 = ((2, 4), ("data", "ctx"))     # a ctx axis of 4 (data replicated)
CTX2 = ((4, 2), ("data", "ctx"))     # a ctx axis of 2
HEAD_CTX = ((2, 4), ("head", "ctx"))


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d), dtype=np.float32)
            for h in (hq, hkv, hkv)]


# name -> (mode, jax options, inputs, mesh): each run by the port on the
# mesh's ctx axis and by JAX on a mesh of the same ctx size
CASES = {
    "ring causal": ("ring", {"causal": True}, _qkv(0, 1, 2, 2, 512, 64), CTX4),
    "ring non-causal": ("ring", {"causal": False}, _qkv(0, 1, 2, 2, 512, 64),
                        CTX4),
    "ulysses causal": ("ulysses", {"causal": True},
                       _qkv(1, 1, 4, 4, 512, 64), CTX4),
    "ulysses non-causal": ("ulysses", {"causal": False},
                           _qkv(1, 1, 4, 4, 512, 64), CTX4),
    "allgather": ("allgather", {}, _qkv(2, 1, 2, 2, 256, 64), CTX4),
    "ring 2d": ("ring", {"causal": True}, _qkv(3, 1, 4, 4, 256, 64),
                HEAD_CTX),
    "zigzag 2": ("zigzag", {}, _qkv(5, 1, 2, 2, 512, 64), CTX2),
    "zigzag 4": ("zigzag", {}, _qkv(5, 1, 2, 2, 512, 64), CTX4),
    "ring gqa 8/2": ("ring", {"causal": True}, _qkv(6, 1, 8, 2, 256, 64),
                     CTX4),
    "ulysses gqa 8/4": ("ulysses", {"causal": True},
                        _qkv(7, 1, 8, 4, 256, 64), CTX4),
    "ring bf16": ("ring", {"causal": True}, _qkv(8, 1, 2, 2, 512, 64), CTX4),
}
GRAD_CASES = {
    "ring": ("ring", {"causal": True}, _qkv(9, 1, 2, 2, 256, 64)),
    "ulysses": ("ulysses", {"causal": True}, _qkv(10, 1, 8, 4, 256, 64)),
    "allgather": ("allgather", {}, _qkv(11, 1, 2, 2, 256, 64)),
}
SHARDED = _qkv(12, 4, 4, 2, 256, 64)
EVENTS = _qkv(13, 1, 2, 2, 256, 64)


def _port_inputs(name, inputs):
    if name.endswith("bf16"):
        return [torch.from_numpy(x).to(torch.bfloat16) for x in inputs]
    return inputs


def _jobs():
    jobs = []
    for spec in (CTX4, CTX2, HEAD_CTX):
        cases = [(name, mode, _port_inputs(name, inputs), opts)
                 for name, (mode, opts, inputs, mesh) in CASES.items()
                 if mesh == spec]
        if spec == CTX4:
            cases += [(f"grad {name}", mode, inputs, {**opts, "grad": True})
                      for name, (mode, opts, inputs) in GRAD_CASES.items()]
        jobs.append(("run_cases", (spec, cases)))
    jobs.append(("run_sharded_flash", (SHARDED, True)))
    jobs += [("ring_events", (((WORLD // 2, 2), ("ctx", "data")), EVENTS,
                              causal)) for causal in (True, False)]
    return jobs


@pytest.fixture(scope="module")
def world():
    """Every rank's results of every job, one world of 8 for the module."""
    per_rank = run_world(RK.run_jobs, WORLD, backend="gloo",
                         device_type="cpu", args=(_jobs(),),
                         timeout_s=TIMEOUT_S)
    merged = []
    for results in per_rank:
        cases = {}
        for part in results[:3]:
            cases.update(part)
        merged.append({"cases": cases, "sharded": results[3],
                       "events": {True: results[4], False: results[5]}})
    return merged


def _jax_mesh(n, names=("ctx",), shape=None):
    devs = np.asarray(jax.devices()[:n])
    return Mesh(devs.reshape(shape or (n,)), names)


def _jax_fn(mode, opts, mesh, spec, config=None):
    kw = {} if config is None else {"config": config}
    if mode == "ring":
        local = JR.make_ring_attention(mesh, causal=opts["causal"], **kw)
    elif mode == "zigzag":
        local = JR.make_zigzag_ring_attention(mesh, **kw)
    elif mode == "ulysses":
        local = JR.make_ulysses_attention(mesh, causal=opts["causal"], **kw)
    else:
        local = JR.make_allgather_attention(mesh, **kw)
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                                 out_specs=spec, check_vma=False))


def _jax_run(mode, opts, inputs, mesh_spec, dtype=jnp.float32, config=None):
    shape, names = mesh_spec
    ctx = shape[names.index("ctx")]
    if "head" in names:
        mesh = _jax_mesh(WORLD, ("head", "ctx"), shape)
        spec = P(None, "head", "ctx", None)
    else:
        mesh = _jax_mesh(ctx)
        spec = P(None, None, "ctx", None)
    q, k, v = (jnp.asarray(x, dtype) for x in inputs)
    f = _jax_fn(mode, opts, mesh, spec, config)
    if mode == "zigzag":
        zq, zk, zv = (JR.zigzag_permute(x, ctx) for x in (q, k, v))
        return np.asarray(JR.zigzag_unpermute(f(zq, zk, zv), ctx), np.float32)
    return np.asarray(f(q, k, v).astype(jnp.float32))


def _port(world, name, rank=0):
    got = world[rank]["cases"][name]
    return got.float().numpy() if isinstance(got, torch.Tensor) else got


def _assert_close(got, want, atol, what):
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= atol, f"{what}: max err {err:.3e} > {atol:.0e}"


@pytest.mark.parametrize("name", [n for n in CASES if n != "ring bf16"])
def test_mode_matches_jax(world, name):
    mode, opts, inputs, mesh_spec = CASES[name]
    want = _jax_run(mode, opts, inputs, mesh_spec)
    _assert_close(_port(world, name), want, 2e-5, name)


def test_bf16_ring_matches_jax(world):
    mode, opts, inputs, mesh_spec = CASES["ring bf16"]
    want = _jax_run(mode, opts, inputs, mesh_spec, dtype=jnp.bfloat16)
    _assert_close(_port(world, "ring bf16"), want, 2e-2, "ring bf16")


@pytest.mark.parametrize("name", ["ring causal", "zigzag 4"])
def test_jax_kernel_path_matches_port_plain_path(world, name):
    """JAX's ring with an explicit FlashConfig runs its Pallas kernel
    (interpret mode on the CPU); the port's ranks run the plain forward."""
    mode, opts, inputs, mesh_spec = CASES[name]
    cfg = FlashConfig(block_q=128, block_kv=128, interpret=True)
    want = _jax_run(mode, opts, inputs, mesh_spec, config=cfg)
    _assert_close(_port(world, name), want, 2e-5, f"{name} + kernel")


def test_every_rank_returns_the_global_output(world):
    for rank in range(1, WORLD):
        for name, got in world[rank]["cases"].items():
            want = world[0]["cases"][name]
            if isinstance(got, list):
                assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            else:
                assert torch.equal(got, want), (rank, name)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_gradients_match_jax_grad(world, name):
    """Backprop through the rotations (their transposes), the all-to-alls
    and the all-gather, against jax.grad through JAX's shard_map."""
    mode, opts, inputs = GRAD_CASES[name]
    mesh = _jax_mesh(4)
    spec = P(None, None, "ctx", None)
    f = _jax_fn(mode, opts, mesh, spec)

    def loss(q, k, v):
        return (f(q, k, v).astype(jnp.float32) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in inputs))
    out, *port_grads = world[0]["cases"][f"grad {name}"]
    _assert_close(out.numpy(), _jax_run(mode, opts, inputs, CTX4), 2e-5,
                  f"{name} out")
    for what, got, want in zip(("dq", "dk", "dv"), port_grads, grads):
        _assert_close(got.numpy(), np.asarray(want), 1e-3, f"{name} {what}")


def test_zigzag_permutation_roundtrip():
    x = torch.arange(3 * 2 * 48 * 4, dtype=torch.float32).reshape(3, 2, 48, 4)
    assert torch.equal(TR.zigzag_unpermute(TR.zigzag_permute(x, 4), 4), x)
    np.testing.assert_array_equal(TR.zigzag_permutation(48, 4),
                                  JR.zigzag_permutation(48, 4))
    want = np.asarray(JR.zigzag_permute(jnp.asarray(x.numpy()), 4))
    np.testing.assert_array_equal(TR.zigzag_permute(x, 4).numpy(), want)


@pytest.mark.parametrize("n", range(1, WORLD + 1))
def test_make_mesh_split_matches_jax(n):
    assert mesh_shape(n) == JS.make_mesh(n).devices.shape


def test_make_mesh_in_a_world(world):
    assert world[0]["sharded"]["mesh"] == [4, 2]
    assert tuple(world[0]["sharded"]["default"]) == \
        JS.make_mesh(WORLD).devices.shape


def test_sharded_flash_attention_matches_jax(world):
    mesh = JS.make_mesh(8, data=4, model=2)
    f = JS.sharded_flash_attention(mesh, causal=True)
    want = np.asarray(f(*(jnp.asarray(x) for x in SHARDED)))
    for rank in range(WORLD):
        _assert_close(world[rank]["sharded"]["out"].numpy(), want, 2e-5,
                      f"sharded flash, rank {rank}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal",
                                                        "non-causal"])
def test_rotation_posted_before_each_steps_flash(world, causal):
    """tests/test_ring_overlap.py's issue order: every step posts its
    rotation before its flash call, and collects it after; causal rank i
    launches i + 1 flash calls, non-causal n."""
    n = WORLD // 2
    for rank in range(WORLD):
        events = world[rank]["events"][causal]["events"]
        steps, cur = [], []
        for e in events:
            cur.append(e)
            if e == "recv":
                steps.append(cur)
                cur = []
        steps.append(cur)
        assert len(steps) == n
        for step in steps[:-1]:
            assert step[0] == "post" and step[-1] == "recv", events
        assert "post" not in steps[-1]
        idx = rank // 2      # the ctx coordinate on the (ctx, data) mesh
        assert events.count("flash") == (idx + 1 if causal else n), events


@pytest.mark.parametrize("causal", [True, False], ids=["causal",
                                                        "non-causal"])
def test_each_step_sends_the_block_it_received(world, causal):
    """tests/test_ring_overlap.py's dataflow property: a rotation never
    waits on attention output; it forwards the block it received."""
    for rank in range(WORLD):
        sent = world[rank]["events"][causal]["sent_received"]
        assert sent == [True] * (WORLD // 2 - 1)


def test_nccl_without_a_card_per_rank_raises():
    with pytest.raises((ValueError, RuntimeError), match="nccl|CUDA"):
        run_world(RK.fail_on_rank, 2, backend="nccl", device_type="cpu",
                  args=(-1,))
    with pytest.raises(ValueError, match="backend"):
        run_world(RK.fail_on_rank, 2, backend="mpi", device_type="cpu",
                  args=(-1,))


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        run_world(RK.fail_on_rank, 2, backend="gloo", device_type="cpu",
                  args=(1,), timeout_s=60)
    assert "planted failure on rank 1" in str(err.value)


def test_ranks_that_never_meet_fail_fast():
    """A rank left waiting (a deadlocked ring) fails the world within its
    deadline instead of hanging the caller."""
    with pytest.raises((RuntimeError, TimeoutError)):
        run_world(RK.unmatched_recv, 2, backend="gloo", device_type="cpu",
                  timeout_s=30)


def test_a_world_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        run_world(RK.fail_on_rank, 1, backend="gloo", args=(-1,))
