"""A world of ranks on one host: the launcher the context-parallel layer runs in.

JAX drives a mesh from one process (`shard_map` over `jax.devices()`);
torch.distributed runs one process a rank. `run_world(fn, n, ...)` spawns n
ranks, joins them into one process group and returns what `fn` returned on
each. The parent binds the group's store on a free port of its own, so
worlds run side by side (test workers start them at the same time). Every
world has a deadline: a rank stuck in a collective fails the world after
`timeout_s` instead of hanging its caller.

The backend is the caller's choice and is never picked quietly: "nccl"
takes CUDA tensors and needs a card a rank (NCCL refuses two ranks on one
card), "gloo" runs anywhere and moves host memory (`parallel/comm.py`
copies CUDA tensors through the host for it, and counts the bytes).
"""

from __future__ import annotations

import datetime
import io
import os
import pickle
import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 120.0
_HOST = "127.0.0.1"


def run_world(fn, n: int, *, backend: str, device_type: str = "cuda",
              args=(), timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Runs `fn(rank, device, *args)` on each of n spawned ranks of one
    process group; returns each rank's result in rank order.

    fn must be importable by name from a module the ranks can import (a
    spawned rank imports it afresh); its result is sent back with
    `torch.save` (tensors, numbers, strings, lists, tuples and dicts).
    A rank's device is `cuda:{rank % device_count}`, or the CPU with
    device_type="cpu". On CUDA the kernels are built here first, so the
    ranks do not each run nvcc. Raises RuntimeError with the traceback of
    the first rank that fails (the other ranks are then stopped), and
    TimeoutError when the world has not finished after timeout_s.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass "
                               "device_type='cpu' for a world on the CPU")
        from tiny_flash_attention_tpu_torch import _build

        _build.build()
    if backend == "nccl" and (device_type != "cuda"
                              or n > torch.cuda.device_count()):
        raise ValueError(
            f"nccl needs a CUDA card for each rank: {n} ranks, "
            f"{torch.cuda.device_count() if device_type == 'cuda' else 0} "
            f"cards; take backend='gloo' to share cards")
    store = dist.TCPStore(_HOST, 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, n, store.port, backend, device_type, timeout_s, fn, inbox,
        results)) for rank in range(n)]
    for p in procs:
        p.start()
    # the arguments go by queue, not with the process: a start() blocks
    # until its rank has read what it was given, so large arguments would
    # start the ranks one after another
    payload = pickle.dumps(tuple(args))
    for _ in procs:
        inbox.put(payload)
    try:
        return _collect(procs, results, n, time.monotonic() + timeout_s)
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()


def _collect(procs, results, n: int, deadline: float) -> list:
    got = {}
    while len(got) < n:
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue_mod.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                _stop(procs)
                raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                   f"{dead[0][1]} before it returned")
            if time.monotonic() > deadline:
                _stop(procs)
                raise TimeoutError(
                    f"the world of {n} ranks did not finish in time; ranks "
                    f"{sorted(set(range(n)) - set(got))} still running")
            continue
        if not ok:
            _stop(procs)
            raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
        got[rank] = torch.load(io.BytesIO(payload), map_location="cpu",
                               weights_only=True)
    return [got[r] for r in range(n)]


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()


def _rank_main(rank, n, port, backend, device_type, timeout_s, fn, inbox,
               results) -> None:
    # one host: the group's sockets stay on the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            # the ranks of a CPU world share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        args = pickle.loads(inbox.get(timeout=timeout_s))
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore(_HOST, port, is_master=False, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n, timeout=timeout)
        try:
            out = fn(rank, device, *args)
            if device_type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            dist.destroy_process_group()
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise
