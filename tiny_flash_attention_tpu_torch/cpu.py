"""The native C++/OpenMP CPU oracle (cpp/attn.cpp) on CPU torch tensors.

Port of tiny_flash_attention_tpu/cpu.py: the same five functions and
keyword arguments, bound to the same C ABI with ctypes (its own copy of the
`AttnParams` struct and of the argument types). This is the host oracle,
as JAX's is a numpy one, and no device entry point: it takes CPU tensors
(or numpy arrays) and returns CPU tensors, out in the function's dtype and
the LSE in f32; a CUDA tensor raises ValueError (nothing is copied to the
host quietly).

The library is compiled at first use from cpp/attn.cpp with the host C++
compiler (`g++`, else `c++`, on PATH) and cpp/Makefile's flags plus
-shared, into build/cpu/libtfa_cpu-<hash>.so; the hash covers the source,
the header, the compiler, the flags and the host's CPU (-march=native
compiles for it), so an edit, or a copy of the tree on another host,
builds anew. The build writes a temporary file and renames it under a
file lock, so concurrent test processes do not race. `make` is not run,
and a missing compiler raises: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPP_DIR = ROOT / "cpp"
BUILD_DIR = ROOT / "build" / "cpu"
# cpp/Makefile's CXXFLAGS, and -shared as its library rule adds
FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17", "-Wall",
         "-shared")
COMPILE_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None


class _AttnParams(ctypes.Structure):
    """cpp/attn.h's AttnParams."""
    _fields_ = [
        ("bs", ctypes.c_int64),
        ("hq", ctypes.c_int64),
        ("hkv", ctypes.c_int64),
        ("q_len", ctypes.c_int64),
        ("kv_len", ctypes.c_int64),
        ("d", ctypes.c_int64),
        ("causal", ctypes.c_int32),
        ("sm_scale", ctypes.c_float),
    ]


def _compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the CPU "
                       "oracle builds cpp/attn.cpp at first use")


def _host_cpu() -> str:
    """The host CPU's model and feature flags (-march=native targets
    them), from /proc/cpuinfo where there is one."""
    try:
        lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return ""
    keep = [line for line in lines
            if line.startswith(("model name", "flags"))]
    return "\n".join(keep[:2])


def library_path() -> pathlib.Path:
    """Where the library of the current source, header, compiler, flags
    and host CPU lies (built or not)."""
    cxx = _compiler()
    key = b"".join((CPP_DIR / n).read_bytes()
                   for n in ("attn.cpp", "attn.h"))
    key += " ".join((cxx, *FLAGS, _host_cpu())).encode()
    return BUILD_DIR / f"libtfa_cpu-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compiles cpp/attn.cpp unless its library is built already; returns
    its path. Each compile adds one to `build.compiles`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock, open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_compiler(), *FLAGS, str(CPP_DIR / "attn.cpp"), "-o",
                 str(tmp)], capture_output=True, text=True,
                timeout=COMPILE_TIMEOUT_S)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building the CPU oracle failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
            build.compiles += 1
    return so


build.compiles = 0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    pp = ctypes.POINTER(_AttnParams)
    lib.naive_attn_f32.argtypes = [f32p, f32p, f32p, f32p, f32p, pp]
    lib.flash_attn_f32.argtypes = [f32p, f32p, f32p, f32p, f32p, pp]
    lib.flash_attn_bf16.argtypes = [u16p, u16p, u16p, u16p, f32p, pp]
    lib.flash_attn_fp16.argtypes = [u16p, u16p, u16p, u16p, f32p, pp]
    for name in ("bf16_to_f32", "fp16_to_f32"):
        getattr(lib, name).argtypes = [u16p, f32p, ctypes.c_int64]
    for name in ("f32_to_bf16", "f32_to_fp16"):
        getattr(lib, name).argtypes = [f32p, u16p, ctypes.c_int64]
    lib.simd_width.restype = ctypes.c_int
    _lib = lib
    return lib


def simd_width() -> int:
    """Lanes of the compiled SIMD path (1: scalar)."""
    return _load().simd_width()


def _host(x, dtype: torch.dtype) -> torch.Tensor:
    """x as a contiguous CPU tensor of `dtype`; a CUDA tensor raises."""
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 arrays
            x = torch.from_numpy(np.ascontiguousarray(x).view(np.uint16)) \
                .view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.ascontiguousarray(x))
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"expected a CPU tensor or numpy array, got "
                         f"{type(x).__name__}")
    if x.device.type != "cpu":
        raise ValueError(f"the CPU oracle takes CPU tensors; got one on "
                         f"{x.device} (copy it to the host explicitly)")
    return x.to(dtype).contiguous()


def _run(fn, dtype, q, k, v, causal, sm_scale, return_lse):
    q, k, v = (_host(x, dtype) for x in (q, k, v))
    bs, hq, q_len, d = q.shape
    _, hkv, kv_len, dk = k.shape
    if hq % hkv or dk != d or v.shape != k.shape or k.shape[0] != bs:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    p = _AttnParams(bs, hq, hkv, q_len, kv_len, d, int(causal),
                    float(sm_scale))
    out = torch.empty_like(q)
    lse = (torch.empty((bs, hq, q_len), dtype=torch.float32) if return_lse
           else None)
    ptr = ctypes.POINTER(ctypes.c_float if dtype == torch.float32
                         else ctypes.c_uint16)

    def arg(t, kind=ptr):
        return ctypes.cast(t.data_ptr(), kind)

    fn(arg(q), arg(k), arg(v), arg(out),
       None if lse is None else arg(lse, ctypes.POINTER(ctypes.c_float)),
       ctypes.byref(p))
    return (out, lse) if return_lse else out


def naive_attn(q, k, v, *, causal=False, sm_scale=None, return_lse=False):
    """Native 3-pass softmax attention, f32 in and out."""
    return _run(_load().naive_attn_f32, torch.float32, q, k, v, causal,
                sm_scale, return_lse)


def flash_attn(q, k, v, *, causal=False, sm_scale=None, return_lse=False):
    """Native 1-pass streaming flash attention, f32 in and out (for bf16
    use flash_attn_bf16)."""
    return _run(_load().flash_attn_f32, torch.float32, q, k, v, causal,
                sm_scale, return_lse)


def flash_attn_bf16(q, k, v, *, causal=False, sm_scale=None,
                    return_lse=False):
    """bf16 in and out with f32 accumulation."""
    return _run(_load().flash_attn_bf16, torch.bfloat16, q, k, v, causal,
                sm_scale, return_lse)


def flash_attn_fp16(q, k, v, *, causal=False, sm_scale=None,
                    return_lse=False):
    """fp16 in and out with f32 accumulation (the library's bit-exact
    IEEE conversions)."""
    return _run(_load().flash_attn_fp16, torch.float16, q, k, v, causal,
                sm_scale, return_lse)
