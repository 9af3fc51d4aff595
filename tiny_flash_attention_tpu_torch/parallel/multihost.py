"""Multi-host bring-up on torch.distributed: a fail-fast init from the
environment, and the hybrid mesh with one axis across hosts.

Counterpart of tiny_flash_attention_tpu/parallel/multihost.py. JAX runs one
process per TPU host, reaching the chips of a slice over ICI and the hosts
over DCN, and puts the fast-collective axes (tensor, context parallel)
within a slice and only the data-parallel axis across slices. Here a
process is a rank with one card; the cards of one host share its fast links
(NVLink on an H100 host) and the hosts talk over the network, so
`make_hybrid_mesh` puts `dcn_axis` across hosts and `ici_axes` within one.
parallel/world.py::run_world is the launcher of a world on one host; a job
over hosts starts its processes itself (torchrun, a scheduler) and each
calls `initialize_multihost`.

Failure policy, as JAX's: bring-up fails fast and loud. A misconfigured
coordinator or a missing rank raises RuntimeError within `timeout_s` at
init, naming the coordinator, the world size and the rank, instead of
hanging into the first collective.
"""

from __future__ import annotations

import datetime
import math
import os
import socket
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tiny_flash_attention_tpu_torch.parallel.world import BACKENDS
from tiny_flash_attention_tpu_torch.utils.device import resolve_device

_ARRIVED = "multihost/arrived/"


def _coordinator(address: Optional[str]) -> Optional[str]:
    """The coordinator's "host:port": the argument, COORDINATOR_ADDRESS,
    or torchrun's MASTER_ADDR and MASTER_PORT; None if none is set."""
    if address:
        return address
    if os.environ.get("COORDINATOR_ADDRESS"):
        return os.environ["COORDINATOR_ADDRESS"]
    if os.environ.get("MASTER_ADDR"):
        return (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    return None


def _from_env(value: Optional[int], name: str) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"{name} is not set and was not passed")
    return int(os.environ[name])


def _await_listener(host: str, port: int, deadline: float) -> None:
    """Returns once the coordinator accepts a connection; raises
    TimeoutError at the deadline."""
    while True:
        try:
            socket.create_connection(
                (host, port),
                timeout=max(0.1, deadline - time.monotonic())).close()
            return
        except OSError as e:
            if time.monotonic() >= deadline:
                raise TimeoutError(f"nobody listens at {host}:{port}") from e
            time.sleep(0.1)


def _seconds_left(deadline: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=max(0.1, deadline - time.monotonic()))


def initialize_multihost(
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        timeout_s: float = 120, *, backend: Optional[str] = None,
        device=None) -> None:
    """Joins this process to the default process group of a multi-host job.

    Configured by the arguments or by the environment: the coordinator's
    "host:port" from COORDINATOR_ADDRESS or torchrun's MASTER_ADDR and
    MASTER_PORT, the world size and this process's rank from WORLD_SIZE
    and RANK. Rank 0 hosts the group's store at the coordinator's address
    (under torchrun's agent, TORCHELASTIC_USE_AGENT_STORE=True, the agent
    does). With no coordinator configured it returns and does nothing: a
    single-process run.

    The backend is NCCL on the card (the default device; the rank takes
    card LOCAL_RANK, or its rank modulo the cards of its host), gloo only
    when the caller asks for it (`backend="gloo"`) or passes
    `device="cpu"`: it is never picked quietly. Every rank waits at init
    until every other has arrived, so that a missing rank fails here.
    Any failure raises RuntimeError within about `timeout_s`, naming the
    coordinator, num_processes, process_id and the cause.
    """
    address = _coordinator(coordinator_address)
    if address is None:
        return
    try:
        num_processes = _from_env(num_processes, "WORLD_SIZE")
        process_id = _from_env(process_id, "RANK")
        if dist.is_initialized():
            raise RuntimeError("a default process group exists already")
        dev = resolve_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("nccl needs the card; take backend='gloo' on "
                             "the CPU")
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
        host, port = address.rsplit(":", 1)
        deadline = time.monotonic() + timeout_s
        master = process_id == 0 and os.environ.get(
            "TORCHELASTIC_USE_AGENT_STORE") != "True"
        if not master:
            _await_listener(host, int(port), deadline)
        store = dist.TCPStore(host, int(port), world_size=num_processes,
                              is_master=master, wait_for_workers=False,
                              timeout=_seconds_left(deadline))
        store.set(f"{_ARRIVED}{process_id}", "1")
        store.wait([f"{_ARRIVED}{r}" for r in range(num_processes)],
                   _seconds_left(deadline))
        dist.init_process_group(
            backend, store=store, rank=process_id, world_size=num_processes,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # converted: a failed init must not hang
        raise RuntimeError(
            f"multi-host init failed (coordinator={address!r}, "
            f"num_processes={num_processes}, process_id={process_id}): "
            f"{type(e).__name__}: {e}") from e


def _hybrid_rank_array(hosts: Sequence, ici_shape: Sequence[int],
                       num_slices: int) -> torch.Tensor:
    """The ranks as an array of shape [num_slices, *ici_shape]
    (_hybrid_device_array's counterpart): the leading axis walks the hosts,
    the rest walk the ranks of one host. hosts[r] names rank r's host.
    Where there are num_slices distinct hosts, each block holds one host's
    ranks in rank order, the hosts in the order of their lowest rank;
    otherwise (one host standing for several, as a multi-process run on one
    machine) the blocks are contiguous ranks."""
    n = len(hosts)
    per_slice = math.prod(ici_shape)
    if num_slices * per_slice != n:
        raise ValueError(f"{num_slices} slices x {list(ici_shape)} != {n} "
                         f"ranks")
    ranks = list(range(n))
    if num_slices > 1 and len(set(hosts)) == num_slices:
        first = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
        ranks.sort(key=lambda r: (first[hosts[r]], r))
        blocks = [ranks[i:i + per_slice] for i in range(0, n, per_slice)]
        if any(len({hosts[r] for r in b}) != 1 for b in blocks):
            raise ValueError(f"the hosts hold unequal numbers of ranks: "
                             f"{list(hosts)}")
    return torch.tensor(ranks).reshape([num_slices, *ici_shape])


def make_hybrid_mesh(
        ici_axes: Sequence[str] = ("model",),
        ici_shape: Optional[Sequence[int]] = None, dcn_axis: str = "data",
        axis_order: Optional[Sequence[str]] = None,
        num_slices: Optional[int] = None, device=None) -> DeviceMesh:
    """A DeviceMesh over the ranks of the world with `dcn_axis` across
    hosts and `ici_axes` within one, named (dcn_axis, *ici_axes) (or
    `axis_order`, which transposes it). Every rank must call it: the
    hostnames are gathered over the world and the mesh makes its process
    groups with every rank.

    One host gives a mesh whose dcn axis has size 1, so code written for
    the hybrid layout runs unchanged on one host. `num_slices` defaults to
    the number of distinct hosts; a multi-process run on one machine
    passes the number of "hosts" it stands for, and their ranks are then
    contiguous. `ici_shape` defaults to [ranks a slice, 1, ...]. The mesh's
    device type is `device`'s: the card unless the caller asks for the
    CPU.
    """
    dev = resolve_device(device)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    if num_slices is None:
        num_slices = len(set(hosts))
    if ici_shape is None:
        ici_shape = [len(hosts) // num_slices] + [1] * (len(ici_axes) - 1)
    if len(ici_shape) != len(ici_axes):
        raise ValueError(f"ici_shape {list(ici_shape)} for axes "
                         f"{tuple(ici_axes)}")
    arr = _hybrid_rank_array(hosts, list(ici_shape), num_slices)
    names = (dcn_axis, *ici_axes)
    if axis_order is not None:
        arr = arr.permute([names.index(a) for a in axis_order])
        names = tuple(axis_order)
    return DeviceMesh(dev.type, arr, mesh_dim_names=names)
