"""The port's native CPU oracle (cpu.py) against the JAX package's.

Mirrors tests/test_cpu_native.py case for case. Both bind cpp/attn.cpp,
compiled with cpp/Makefile's flags (the port builds its own library into
build/cpu/, JAX's is cpp/libtfa_cpu.so), so on the same inputs the port's
functions give the JAX `cpu` functions' bits; they are also held against
the port's own oracle ladder (ops/reference.py) at the JAX test's
tolerances. Then: a tensor that is not on the CPU is refused, and a second
build with the same hash reuses the library. Inputs come from numpy seeds.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from tiny_flash_attention_tpu import cpu as jcpu
from tiny_flash_attention_tpu_torch import cpu
from tiny_flash_attention_tpu_torch.ops import reference as R


def make_qkv(seed, bs, hq, hkv, q_len, kv_len, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bs, hq, q_len, d), np.float32),
            rng.standard_normal((bs, hkv, kv_len, d), np.float32),
            rng.standard_normal((bs, hkv, kv_len, d), np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(got, want, atol, name=""):
    err = float((got.float() - want.float()).abs().max())
    assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.1e}"


def _same_bits(got: torch.Tensor, want: np.ndarray):
    """got's bytes are want's (both views of the same dtype width)."""
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(
        got.view(torch.int16 if got.element_size() == 2 else torch.int32)
        .numpy(),
        np.ascontiguousarray(want).view(
            np.int16 if want.dtype.itemsize == 2 else np.int32))


def test_simd_path_compiled():
    assert cpu.simd_width() == jcpu.simd_width()
    assert cpu.simd_width() in (1, 8, 16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["naive_attn", "flash_attn"])
def test_native_vs_jax_oracle(name, causal):
    q, k, v = make_qkv(0, 2, 4, 4, 64, 64, 64)
    got = getattr(cpu, name)(*_t(q, k, v), causal=causal)
    _same_bits(got, getattr(jcpu, name)(q, k, v, causal=causal))
    want = R.mha_reference(*_t(q, k, v), causal=causal,
                           impl=R.attention_naive)
    _close(got, want, 1e-5, name)


def test_native_gqa_decode_shape():
    q, k, v = make_qkv(1, 1, 8, 2, 5, 96, 64)
    got = cpu.flash_attn(*_t(q, k, v), causal=True)
    _same_bits(got, jcpu.flash_attn(q, k, v, causal=True))
    want = R.mha_reference(*_t(q, k, v), causal=True,
                           impl=R.attention_naive)
    _close(got, want, 1e-5)


def test_native_lse():
    q, k, v = make_qkv(2, 1, 2, 2, 32, 32, 32)
    out, lse = cpu.flash_attn(*_t(q, k, v), causal=True, return_lse=True)
    jout, jlse = jcpu.flash_attn(q, k, v, causal=True, return_lse=True)
    _same_bits(out, jout)
    _same_bits(lse, jlse)
    assert lse.dtype == torch.float32
    _, want_lse = R.mha_reference(*_t(q, k, v), causal=True,
                                  impl=R.flash_attention_v2_ref,
                                  return_lse=True)
    _close(lse, want_lse, 1e-4, "lse")


def test_native_bf16():
    q, k, v = make_qkv(3, 1, 2, 2, 64, 64, 64)
    qb, kb, vb = _t(q, k, v, dtype=torch.bfloat16)
    got = cpu.flash_attn_bf16(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    bits = [x.view(torch.int16).numpy().view(np.uint16) for x in (qb, kb, vb)]
    want_bits = jcpu._run_u16(jcpu._load().flash_attn_bf16, *bits, True,
                              None, False)
    _same_bits(got, want_bits)
    want = R.mha_reference(qb, kb, vb, causal=True, impl=R.attention_naive)
    _close(got, want, 2e-2)


def test_native_fp16():
    q, k, v = make_qkv(5, 1, 2, 2, 64, 64, 64)
    qh, kh, vh = (x.astype(np.float16) for x in (q, k, v))
    got = cpu.flash_attn_fp16(qh, kh, vh, causal=True)
    assert got.dtype == torch.float16
    _same_bits(got, jcpu.flash_attn_fp16(qh, kh, vh, causal=True))
    want = R.mha_reference(*_t(qh, kh, vh, dtype=torch.float16),
                           causal=True, impl=R.attention_naive)
    _close(got, want, 1e-2)


def test_fp16_conversions_bit_exact():
    """The port's library's fp16<->f32 conversions match IEEE semantics
    exactly (all 65536 load patterns; RNE store incl. subnormals, overflow,
    signed zero)."""
    lib = cpu._load()
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    src = np.arange(65536, dtype=np.uint16)
    dst = np.empty(65536, np.float32)
    lib.fp16_to_f32(src.ctypes.data_as(u16p), dst.ctypes.data_as(f32p), 65536)
    want = src.view(np.float16).astype(np.float32)
    assert ((dst == want) | (np.isnan(dst) & np.isnan(want))).all()

    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.normal(0, 1, 50000), rng.normal(0, 1e-6, 20000),
        rng.normal(0, 1e5, 20000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0, 65520.0,
         2.0**-24, 2.0**-25, 1.5 * 2.0**-25, -(2.0**-14)],
    ]).astype(np.float32)
    out = np.empty(vals.size, np.uint16)
    lib.f32_to_fp16(vals.ctypes.data_as(f32p), out.ctypes.data_as(u16p),
                    vals.size)
    with np.errstate(over="ignore"):
        want16 = vals.astype(np.float16).view(np.uint16)
    nan = np.isnan(vals)
    assert (out[~nan] == want16[~nan]).all()
    assert np.isnan(out[nan].view(np.float16)).all()


def test_native_sm_scale():
    q, k, v = make_qkv(4, 1, 2, 2, 32, 32, 64)
    got = cpu.flash_attn(*_t(q, k, v), sm_scale=0.25)
    _same_bits(got, jcpu.flash_attn(q, k, v, sm_scale=0.25))
    want = R.mha_reference(*_t(q, k, v), sm_scale=0.25,
                           impl=R.attention_naive)
    _close(got, want, 1e-5)


def test_tensor_off_the_cpu_is_refused():
    """The oracle takes host tensors only: a tensor on another device (a
    CUDA one on the card, tests/test_torch_cuda.py; here one on the meta
    device) raises ValueError, nothing is copied."""
    q = torch.zeros((1, 2, 8, 64), device="meta")
    for fn in (cpu.naive_attn, cpu.flash_attn, cpu.flash_attn_bf16,
               cpu.flash_attn_fp16):
        with pytest.raises(ValueError, match="CPU tensors"):
            fn(q, q, q)


def test_second_build_reuses_the_library(tmp_path, monkeypatch):
    """A build into an empty directory compiles cpp/attn.cpp once with the
    host compiler (never `make`), to libtfa_cpu-<hash>.so; a second build
    with the same hash finds it and compiles nothing."""
    monkeypatch.setattr(cpu, "BUILD_DIR", tmp_path)
    calls = []
    real_run = subprocess.run

    def run(args, **kw):
        calls.append(args)
        return real_run(args, **kw)

    monkeypatch.setattr(subprocess, "run", run)
    before = cpu.build.compiles
    path = cpu.build()
    assert path.parent == tmp_path and path.name.startswith("libtfa_cpu-")
    assert cpu.build.compiles == before + 1 and len(calls) == 1
    assert "make" not in calls[0][0] and "-shared" in calls[0]
    assert cpu.build() == path == cpu.library_path()
    assert cpu.build.compiles == before + 1 and len(calls) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == [path.name]
