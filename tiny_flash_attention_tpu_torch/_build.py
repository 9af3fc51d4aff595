"""Builds the port's CUDA kernels with nvcc at first use; loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/kernels/lib<name>-<hash>.so` for sm_90a. All sources that need a build
compile at once, one nvcc process each. The hash covers the source, the
shared headers `csrc/*.cuh` and the flags (tile sizes included), so an edited
source or header or a new tile config builds anew and a stale library is
never loaded. The wrappers in `ops/` pass pointers and the stream as
`c_void_p` and raise when a C entry returns a nonzero `cudaError_t`. Nothing is built or loaded at import: the CPU tests
import every module of the port.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from tiny_flash_attention_tpu_torch.ops.configs import nvcc_defines

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds each source's nvcc took in this process's builds
build_seconds: dict[str, float] = {}


def _flags() -> list[str]:
    return ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            *nvcc_defines()]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def sources() -> list[str]:
    """Names of the kernel sources under csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(_flags()).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str] | None = None) -> float:
    """Compiles the named sources (default: all) not built yet, in parallel.

    Returns the seconds spent (each source's nvcc in `build_seconds`).
    Raises if any nvcc fails; its output is in `build_log(name)`.
    """
    names = sources() if names is None else names
    t0 = time.perf_counter()
    with _lock:
        todo = [(n, *_target(n)) for n in names]
        todo = [(n, src, so) for n, src, so in todo if not so.exists()]
        if not todo:
            return time.perf_counter() - t0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, src, so in todo:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            with open(so.with_suffix(".log"), "w") as log:
                procs.append((name, so, tmp, subprocess.Popen(
                    [nvcc, *_flags(), "-o", str(tmp), str(src)],
                    stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        pending = list(procs)
        while pending:
            time.sleep(0.05)
            waited = time.perf_counter() - t0
            for item in list(pending):
                name, so, tmp, proc = item
                rc = proc.poll()
                if rc is None and waited > NVCC_TIMEOUT_S:
                    proc.kill()
                    proc.wait()
                    rc = -1
                if rc is None:
                    continue
                pending.remove(item)
                build_seconds[name] = waited
                if rc == 0:
                    os.replace(tmp, so)
                else:
                    failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}; logs: "
                + ", ".join(str(_target(n)[1].with_suffix('.log'))
                            for n in failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for a source (ptxas register and spill lines)."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_target(name)[1]))
    with _lock:
        return _libs.setdefault(name, lib)


def on_device(dev: torch.device):
    """Makes `dev` the current CUDA device for a launch, or does nothing
    when it already is: entering `torch.cuda.device` costs host time on
    every call, and the decode step, which launches its kernels dozens of
    times, is bound by the host."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check(err: int, what: str) -> None:
    """Raises if a C entry returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
