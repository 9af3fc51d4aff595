"""The port's flash-attention backward against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX backward kernels
in interpret mode (`tri_flash_bwd`, `tri_flash_bwd_banded`, and
`flash_attention_bwd` on its fused and its split path) and through the
port's `flash_attention_bwd`, which on the CPU is its plain version. Both
get the same forward out and LSE (JAX's `_xla_attention`). Gates: f32 at
the JAX tests' own 1e-5, bf16 at 2e-2 of the largest |gradient| (the tri
kernels scale the scores after the q k^T product; the port folds the scale
into q in bf16 before it, as the work-list kernels do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_flash_attention_tpu.ops.flash_bwd as JFB
from tiny_flash_attention_tpu.ops.flash import _xla_attention
from tiny_flash_attention_tpu.ops.flash_tri_bwd import (
    tri_flash_bwd, tri_flash_bwd_banded)
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(q_shape, kv_shape, dtype, seed, causal=True, sm_scale=None):
    """(torch q, k, v, out, lse, do), (the same in JAX)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape, q_shape)]
    jq, jk, jv, jdo = (jnp.asarray(a, _JNP[dtype]) for a in arrs)
    sm_scale = sm_scale or q_shape[-1] ** -0.5
    jout, jlse = _xla_attention(jq, jk, jv, None, causal, sm_scale, True)
    jax_args = (jq, jk, jv, jout, jlse, jdo)
    torch_args = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
                  for a in jax_args]
    torch_args = [t if i == 4 else t.to(dtype)      # the LSE stays f32
                  for i, t in enumerate(torch_args)]
    return tuple(torch_args), jax_args


def _check(got, want, dtype, atol_f32=1e-5):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape, name
        atol = atol_f32 if dtype == torch.float32 \
            else 2e-2 * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.3e}"


@pytest.mark.parametrize("q_shape,kv_shape,dtype,sub", [
    pytest.param((2, 4, 384, 64), (2, 2, 384, 64), torch.float32, 256,
                 id="f32-gqa"),
    pytest.param((1, 4, 256, 64), (1, 1, 256, 64), torch.bfloat16, 128,
                 id="bf16-group4"),
])
def test_matches_tri_flash_bwd(q_shape, kv_shape, dtype, sub):
    targs, jargs = _inputs(q_shape, kv_shape, dtype, seed=13, sm_scale=0.125)
    want = tri_flash_bwd(*jargs, sm_scale=0.125, sub=sub, leaf=128,
                         interpret=True)
    got = flash_attention_bwd(*targs, causal=True, sm_scale=0.125)
    assert all(g.dtype == dtype for g in got)
    _check(got, want, dtype)


def test_matches_tri_flash_bwd_banded():
    targs, jargs = _inputs((1, 4, 768, 64), (1, 2, 768, 64), torch.float32,
                           seed=23, sm_scale=0.125)
    want = tri_flash_bwd_banded(*jargs, sm_scale=0.125, sub=256, leaf=128,
                                band_rows=256, interpret=True)
    got = flash_attention_bwd(*targs, causal=True, sm_scale=0.125)
    _check(got, want, torch.float32)


@pytest.mark.parametrize("path", ["fused", "split"])
@pytest.mark.parametrize("q_shape,kv_shape,causal", [
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), True, id="causal"),
    pytest.param((1, 4, 256, 64), (1, 2, 256, 64), False, id="noncausal"),
    pytest.param((1, 2, 100, 80), (1, 2, 200, 80), True, id="decode-offset"),
    # rows 0..129 see no column: the LSE sentinel guard zeroes their p
    pytest.param((1, 4, 200, 64), (1, 2, 70, 64), True, id="q-longer-than-kv"),
])
def test_matches_flash_attention_bwd(monkeypatch, q_shape, kv_shape, causal,
                                     path):
    if path == "split":
        monkeypatch.setattr(JFB, "_FUSED_SCRATCH_LIMIT", 0)
    sc = q_shape[-1] ** -0.5
    targs, jargs = _inputs(q_shape, kv_shape, torch.float32, seed=21,
                           causal=causal)
    want = JFB.flash_attention_bwd(*jargs, causal=causal, sm_scale=sc,
                                   block_q=128, block_kv=128, interpret=True)
    got = flash_attention_bwd(*targs, causal=causal, sm_scale=sc)
    _check(got, want, torch.float32)
    empty = q_shape[2] - kv_shape[2]
    if causal and empty > 0:
        assert torch.all(got[0][:, :, :empty] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("q_shape,kv_shape,causal", [
    pytest.param((2, 4, 96, 64), (2, 2, 96, 64), True, id="causal-gqa"),
    pytest.param((1, 4, 80, 64), (1, 1, 112, 64), False, id="noncausal"),
    pytest.param((1, 4, 24, 64), (1, 2, 120, 64), True, id="decode-offset"),
    pytest.param((1, 2, 90, 64), (1, 2, 40, 64), True, id="q-longer-than-kv"),
])
def test_autograd_matches_autograd_through_plain(q_shape, kv_shape, causal,
                                                 dtype):
    """flash_attention's autograd Function (its backward is
    flash_attention_bwd) against torch autograd through the plain forward.
    fp16 computes in f32 and its gradient flows back through the casts.
    Gates: f32 2e-5, bf16 2e-2 and fp16 1e-2 of the largest |gradient|."""
    rng = np.random.default_rng(31)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(dtype).requires_grad_()
              for s in (q_shape, kv_shape, kv_shape)]
    w = torch.from_numpy(rng.standard_normal(q_shape).astype(np.float32))
    out = flash_attention(*leaves, causal=causal)
    assert out.dtype == dtype and out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    plain_in = [t.float() if dtype == torch.float16 else t for t in leaves]
    ref = flash_attention_plain(*plain_in, causal=causal,
                                sm_scale=q_shape[-1] ** -0.5).to(dtype)
    want = torch.autograd.grad((ref.float() * w).sum(), leaves)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        scale = float(r.float().abs().max())
        atol = {torch.float32: 2e-5, torch.bfloat16: 2e-2 * scale,
                torch.float16: 1e-2 * scale}[dtype]
        err = float((g.float() - r.float()).abs().max())
        assert err <= atol, f"{name}: {err:.3e} > {atol:.3e}"


def test_return_lse_and_window_stay_off_the_function():
    """return_lse=True is forward-only, as in JAX; on the CPU a window or
    segment ids take the plain forward, which torch autograd
    differentiates."""
    q = torch.randn((1, 2, 32, 64), requires_grad=True)
    out, lse = flash_attention(q, q, q, causal=True, return_lse=True)
    assert "FlashAttention" not in type(out.grad_fn).__name__
    out = flash_attention(q, q, q, causal=True, window=8)
    assert "FlashAttention" not in type(out.grad_fn).__name__
    out = flash_attention(q, q, q, causal=True)
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
