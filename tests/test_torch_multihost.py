"""The port's multi-host bring-up across real process boundaries, on the CPU.

Mirrors tests/test_multiprocess.py (benchmarks/multiprocess_smoke.py):
four OS processes (tests/torch_multihost_worker.py, torch only), each
configured by MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK alone through
`initialize_multihost(device="cpu")`, stand for two hosts of two ranks
(`make_hybrid_mesh(num_slices=2)`); every collective crosses a process
boundary. Against JAX in this process: 3 SGD steps with 'data' across the
hosts and 'model' within, within 1e-4 of JAX's single-device oracle; ring
attention with its context axis across the hosts within 2e-5 of
`mha_reference` (the port's in the workers, JAX's here); the sharded
decode loop's greedy tokens exact against the port's single-card loop, and
its sampled tokens too (torch does not reproduce jax.random: the
single-card loop from the same generator state is the reference, as in
tests/test_torch_serve_sharded.py). A coordinator nobody listens on fails
init with RuntimeError within 30 s.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.ops.reference import mha_reference as jax_mha
from tiny_flash_attention_tpu_torch.models import inference as TI
from tiny_flash_attention_tpu_torch.models import transformer as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
NPROC = 4
DEADLINE_S = 180
STEPS = 3
TRAIN = dict(vocab_size=128, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)
SERVE = dict(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)
SERVE_STEPS, SERVE_SEED = 6, 9


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _carry(jcfg, key) -> tuple:
    jp = JT.init_params(jcfg, jax.random.key(key))
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp),
                                  device="cpu")


def _inputs() -> dict:
    """The workers' weights and inputs (JAX's weights carried over), and
    what the test holds their results to."""
    jtrain = JT.ModelConfig(**TRAIN, dtype=jnp.float32,
                            attn_impl="reference")
    jp, tp = _carry(jtrain, 0)
    toks = np.random.default_rng(2).integers(0, 128, (8, 64)).astype(
        np.int32)
    rng = np.random.default_rng(7)
    qkv = [rng.standard_normal((2, 2, 256, 64), dtype=np.float32)
           for _ in range(3)]
    _, sp = _carry(JT.ModelConfig(**SERVE, dtype=jnp.float32,
                                  attn_impl="flash"), 11)
    pages = [torch.zeros((2, 12, 2 * 128, 128)) for _ in range(2)]
    inp = {"train_cfg": TRAIN, "train_params": tp,
           "train_tokens": torch.from_numpy(toks),
           "ring_qkv": [torch.from_numpy(x) for x in qkv],
           "serve_cfg": SERVE, "serve_params": sp, "pages": pages,
           "table": torch.tensor([[1, 2], [3, 4], [7, 8], [9, 10]],
                                 dtype=torch.int32),
           "tokens": torch.tensor([3, 77, 5, 200], dtype=torch.int32),
           "positions": torch.zeros(4, dtype=torch.int32),
           "temps": torch.tensor([0.7, 1.1, 0.9, 1.3]), "seed": SERVE_SEED}
    return inp, (jtrain, jp, toks), qkv


def _jax_losses(jcfg, jp, toks) -> list:
    """JAX's single-device oracle: 3 SGD(1e-2) steps."""
    opt = optax.sgd(1e-2)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(
            lambda p: JT.loss_fn(jcfg, p, jnp.asarray(toks)))(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    params, state, losses = jp, opt.init(jp), []
    for _ in range(STEPS):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return losses


def _single_card_tokens(inp) -> dict:
    """The port's single-card decode_loop on the whole pages."""
    cfg = TT.ModelConfig(**SERVE, dtype=torch.float32)
    out = {}
    for greedy in (True, False):
        temps = inp["temps"] * (0.0 if greedy else 1.0)
        _, tokens, _ = TI.decode_loop(
            cfg, inp["serve_params"], [p.clone() for p in inp["pages"]],
            inp["tokens"], inp["positions"], inp["table"], temps,
            torch.Generator().manual_seed(SERVE_SEED), page_size=128,
            fmt="bf16", n_steps=SERVE_STEPS, greedy=greedy)
        out["greedy" if greedy else "sampled"] = tokens
    return out


def _run_workers(inputs: str, out_dir: str) -> None:
    """The four processes, configured by the environment only; any
    failure or the deadline kills them all."""
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(NPROC), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("COORDINATOR_ADDRESS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, inputs, out_dir],
                              env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(NPROC)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=max(1, deadline -
                                               time.monotonic()))
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_four_processes_configured_by_environment(tmp_path):
    inp, (jcfg, jp, toks), qkv = _inputs()
    inputs = str(tmp_path / "inputs.pt")
    torch.save(inp, inputs)
    _run_workers(inputs, str(tmp_path))
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
           for r in range(NPROC)]

    want = _jax_losses(jcfg, jp, toks)
    ring_want = np.asarray(jax_mha(*(jnp.asarray(x) for x in qkv),
                                   causal=True))
    tokens = _single_card_tokens(inp)
    for r, res in enumerate(got):
        assert res["world"] == NPROC
        assert res["sizes"] == {"data": 2, "model": 2}
        assert res["data"] == r // 2     # 'data' across the two hosts
        np.testing.assert_allclose(res["losses"], want, rtol=0, atol=1e-4)
        assert res["losses"] == got[0]["losses"]
        assert res["ring_err"] < 2e-5
        ring_err = float(np.max(np.abs(res["ring"].numpy() - ring_want)))
        assert ring_err < 2e-5, ring_err
        for kind in ("greedy", "sampled"):
            assert torch.equal(res["serve"][kind], tokens[kind]), kind


def test_unreachable_coordinator_fails_fast():
    """A coordinator nobody listens on: RuntimeError naming it, in a
    subprocess, within 30 s."""
    port = _free_port()
    code = ("from tiny_flash_attention_tpu_torch.parallel.multihost import "
            "initialize_multihost\n"
            f"initialize_multihost('127.0.0.1:{port}', 2, 1, timeout_s=5, "
            "device='cpu')\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=30)
    assert time.monotonic() - t0 < 30
    assert out.returncode != 0
    assert "RuntimeError: multi-host init failed" in out.stderr
    assert f"coordinator='127.0.0.1:{port}'" in out.stderr
    assert "num_processes=2, process_id=1" in out.stderr
