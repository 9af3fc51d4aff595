"""Head dims 257-512 against the JAX package, on the CPU: the training path.

The JAX package pads any head_dim to whole 128-lane tiles in its backward
(ops/flash_bwd.py:478-493), so its backward kernels and `jax.grad` through
its attention take head_dim 384 or 512. The port's bf16 backward reads any
multiple of 8 in (256, 512] in place on its instance of width 512 and pads
the others to 512 (ops/dims.py::flash_head_dim); the f32 backward stops
at 256, though the f32 forward serves to 512 (tests/test_torch_dims.py
holds the refusals).

Here the same numpy inputs, made from a seed, go through JAX's backward
kernels in interpret mode (`flash_attention_bwd` on its fused and its split
path with the masks, `tri_flash_bwd` and `tri_flash_bwd_banded` causal)
and through the port: its public entry (the plain version at the true
head_dim, on the CPU, what the in-place kernels compute) and the route
padded to 512 (zero columns, the plain backward, the gradients sliced
back, their padded columns 0). Both get the same forward out and LSE
(JAX's `_xla_attention`). Gates: f32 at JAX's 1e-5 (against the triangle
kernels 1e-5 of max(1, the largest |gradient|): JAX's own triangle and
fused kernels differ by more than 1e-5 at these sizes), bf16 at 2e-2 of
the largest |gradient|. Autograd through `flash_attention` at 384 and 512 is
autograd through the plain forward; a model at head_dim 512 (2 layers, 8
q heads over 1 kv head) with JAX's weights carried over by
params_from_jax gives JAX's loss, gradients and three SGD steps at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tiny_flash_attention_tpu.ops.flash_bwd as JFB
from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.ops.flash import _xla_attention
from tiny_flash_attention_tpu.ops.flash_tri_bwd import (
    tri_flash_bwd, tri_flash_bwd_banded)
from tiny_flash_attention_tpu.parallel.sharded import make_mesh
from tiny_flash_attention_tpu.parallel.train import (
    make_train_step as jax_make_train_step)
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.ops import configs, dims
from tiny_flash_attention_tpu_torch.ops.flash import (
    flash_attention, flash_attention_plain)
from tiny_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd, flash_attention_bwd_plain)
from tiny_flash_attention_tpu_torch.parallel.train import (
    make_train_step, param_leaves)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
F32, BF16 = torch.float32, torch.bfloat16
# the ids' segment bounds of a 256-token row, as static segment_starts
STARTS = (90, 200)


def _inputs(q_shape, kv_shape, dtype, seed, causal=True, window=None,
            ids=None):
    """(torch q, k, v, out, lse, do), (the same in JAX): the forward's out
    and LSE from JAX's `_xla_attention` under the masks."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape, q_shape)]
    jq, jk, jv, jdo = (jnp.asarray(a, _JNP[dtype]) for a in arrs)
    seg = None if ids is None else (jnp.asarray(ids), jnp.asarray(ids))
    jout, jlse = _xla_attention(jq, jk, jv, seg, causal,
                                q_shape[-1] ** -0.5, True, window=window)
    jax_args = (jq, jk, jv, jout, jlse, jdo)
    torch_args = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
                  for a in jax_args]
    torch_args = [t if i == 4 else t.to(dtype)      # the LSE stays f32
                  for i, t in enumerate(torch_args)]
    return tuple(torch_args), jax_args


def _check(got, want, dtype, what="", scaled=False):
    """f32 at 1e-5 (with `scaled`, of max(1, the largest |gradient|)), bf16
    at 2e-2 of the largest |gradient|."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape, name
        big = float(np.abs(w).max())
        atol = (1e-5 * (max(1.0, big) if scaled else 1.0) if dtype == F32
                else 2e-2 * big)
        err = float(np.abs(g - w).max())
        assert err <= atol, f"{what}{name}: max abs err {err:.3e} > " \
                            f"{atol:.3e}"


def _padded_route(targs, d, **kw):
    """The gradients of the plain backward on tensors padded to 512 with
    zero columns, sliced back; their padded columns must be 0."""
    q, k, v, out, lse, do = targs
    grads = flash_attention_bwd_plain(
        *(dims.pad_head_dim(t, 512) for t in (q, k, v, out)), lse,
        dims.pad_head_dim(do, 512), sm_scale=d ** -0.5, **kw)
    for g in grads:
        assert bool((g[..., d:] == 0).all())
    return tuple(dims.unpad_head_dim(g, d) for g in grads)


# (head_dim, group, mask, dtype): 264 and 392 off JAX's 128-lane tiles,
# 384 on them, 512 the instance's width; DeepSeek-V4-Flash's group of 64
# once
BWD_CASES = [(264, 1, "causal", F32), (264, 8, "full", BF16),
             (264, 8, "window", F32), (264, 1, "ids", BF16),
             (384, 8, "causal", BF16), (384, 1, "full", F32),
             (384, 1, "window", BF16), (384, 8, "ids", F32),
             (512, 1, "causal", F32), (512, 8, "full", BF16),
             (512, 8, "window", F32), (512, 64, "ids", BF16)]


@pytest.mark.parametrize("path", ["fused", "split"])
@pytest.mark.parametrize("d,group,mask,dtype", BWD_CASES,
                         ids=lambda x: str(x).split(".")[-1])
def test_backward_matches_jax(monkeypatch, d, group, mask, dtype, path):
    """JAX's flash_attention_bwd (interpret mode, fused or split) under
    each mask ("ids": segment ids with their static segment_starts); the
    port's entry and its route padded to 512 hold to it."""
    if path == "split":
        monkeypatch.setattr(JFB, "_FUSED_SCRATCH_LIMIT", 0)
    n = 256
    hkv = 2 if group == 1 else 1
    causal = mask != "full"
    kw, jkw = {}, {}
    ids = None
    if mask == "window":
        kw["window"] = jkw["window"] = 100
    if mask == "ids":
        ids = np.zeros((1, n), np.int32)
        for i, x in enumerate(STARTS):
            ids[:, x:] = i + 1
        jkw["segment_ids"] = (jnp.asarray(ids), jnp.asarray(ids))
        jkw["segment_starts"] = STARTS
        seg = torch.from_numpy(ids)
        kw["segment_ids"] = (seg, seg)
    q_shape, kv_shape = (1, hkv * group, n, d), (1, hkv, n, d)
    targs, jargs = _inputs(q_shape, kv_shape, dtype, seed=d + group,
                           causal=causal, window=kw.get("window"), ids=ids)
    want = JFB.flash_attention_bwd(*jargs, causal=causal,
                                   sm_scale=d ** -0.5, block_q=128,
                                   block_kv=128, interpret=True, **jkw)
    starts = {"segment_starts": STARTS} if mask == "ids" else {}
    got = flash_attention_bwd(*targs, causal=causal, **kw, **starts)
    assert all(g.dtype == dtype for g in got)
    _check(got, want, dtype, "entry ")
    _check(_padded_route(targs, d, causal=causal, **kw), want, dtype,
           "padded ")


@pytest.mark.parametrize("d,group,dtype", [(264, 8, F32), (384, 1, BF16),
                                           (512, 8, F32)])
def test_backward_matches_tri_flash_bwd(d, group, dtype):
    """JAX's causal triangle kernel (q_len == kv_len, interpret mode). It
    scales the f32 scores after the q k^T product where the port and the
    work-list kernels fold the scale into q: at group 8 JAX's own triangle
    and fused kernels differ by up to 1.1e-5 in dv (|dv| up to 10.5 at
    384), so f32 is held at 1e-5 of max(1, |gradient|)."""
    q_shape, kv_shape = (1, group, 256, d), (1, 1, 256, d)
    targs, jargs = _inputs(q_shape, kv_shape, dtype, seed=3 * d)
    want = tri_flash_bwd(*jargs, sm_scale=d ** -0.5, sub=128, leaf=128,
                         interpret=True)
    _check(flash_attention_bwd(*targs, causal=True), want, dtype, "entry ",
           scaled=True)
    _check(_padded_route(targs, d, causal=True), want, dtype, "padded ",
           scaled=True)


@pytest.mark.parametrize("d", [392, 512])
def test_backward_matches_tri_flash_bwd_banded(d):
    """JAX's banded triangle kernel (bands of 128 rows, interpret mode) in
    f32, held as the triangle kernel is."""
    q_shape, kv_shape = (1, 2, 384, d), (1, 1, 384, d)
    targs, jargs = _inputs(q_shape, kv_shape, F32, seed=5 * d)
    want = tri_flash_bwd_banded(*jargs, sm_scale=d ** -0.5, sub=128,
                                leaf=128, band_rows=128, interpret=True)
    _check(flash_attention_bwd(*targs, causal=True), want, F32, "entry ",
           scaled=True)
    _check(_padded_route(targs, d, causal=True), want, F32, "padded ",
           scaled=True)


def test_instance_of_width_512_tiles():
    """The backward's instance of width 512: 64-row kv tiles, 32-row q
    steps; its shared memory under the block's limit."""
    assert configs.bwd_config(512) is configs.FLASH_BWD_BF16_512
    assert (configs.bwd_config(512).block_n,
            configs.bwd_config(512).block_m) == (64, 32)
    assert configs.bwd_smem_bytes(512) == 227392 <= 232448
    assert "-DTFA_BWD_BF16_512_BLOCK_M=32" in configs.nvcc_defines()


@pytest.mark.parametrize("d", [384, 512])
def test_autograd_at_the_true_head_dim(d):
    """The autograd Function's gradients (group 8, causal, f32) are those
    of autograd through the plain forward, at the true head_dim."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 8, 100, d), (1, 1, 100, d), (1, 1, 100, d)))
    do = torch.from_numpy(rng.standard_normal((1, 8, 100, d)).astype(
        np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*a, causal=True).backward(do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_plain(*b, causal=True, sm_scale=d ** -0.5).backward(do)
    for x, y in zip(a, b):
        assert x.grad.shape == x.shape
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=0,
                                   atol=2e-5)


# --- a model at head_dim 512 ---------------------------------------------------

WIDTHS = dict(vocab_size=128, d_model=128, n_layers=2, n_q_heads=8,
              n_kv_heads=1, d_head=512, d_ff=256)
JCFG = JT.ModelConfig(**WIDTHS, dtype=jnp.float32)
TCFG = TT.ModelConfig(**WIDTHS, dtype=torch.float32)


def _params(seed=0):
    jp = JT.init_params(JCFG, jax.random.key(seed))
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp),
                                  device="cpu")


def _tokens(seed, shape=(2, 64)):
    return np.random.default_rng(seed).integers(
        0, WIDTHS["vocab_size"], shape).astype(np.int32)


def _jax_leaves(tree) -> list:
    """JAX params in the port's param_leaves order, stacked layers split."""
    layers = tree["layers"]
    n = layers["wq"].shape[0]
    return [np.asarray(tree["embed"]),
            *(np.asarray(layers[name][i]) for i in range(n)
              for name in sorted(layers)),
            np.asarray(tree["final_norm"]), np.asarray(tree["lm_head"])]


def _assert_leaves_close(got: list, want: list, atol: float):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.max(np.abs(g.detach().float().numpy() - w)))
        assert err <= atol, f"leaf {i}: max abs err {err:.3e} > {atol:.0e}"


def test_model_loss_and_grads_match_jax():
    """jax.value_and_grad(loss_fn) at head_dim 512 (n_q_heads * d_head !=
    d_model, as in DeepSeek-V4-Flash) against the port's loss and
    autograd, through the flash autograd Function."""
    jp, tp = _params()
    toks = _tokens(1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(JCFG, p, jnp.asarray(toks)))(jp)
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss = TT.loss_fn(TCFG, tp, torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    _assert_leaves_close([t.grad for t in leaves], _jax_leaves(jgrads),
                         atol=1e-5)


def test_model_sgd_steps_match_jax_train_step():
    """Three SGD steps of make_train_step at head_dim 512 against JAX's
    make_train_step (SGD keeps the update linear in the gradients)."""
    jp, tp = _params(1)
    jstep, jinit = jax_make_train_step(JCFG, make_mesh(1),
                                       optimizer=optax.sgd(1e-2))
    jparams, jopt = jinit(jp)
    step, init = make_train_step(
        TCFG, optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2),
        device="cpu")
    params, opt = init(tp)
    for i in range(3):
        toks = _tokens(10 + i)
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(toks))
        params, opt, loss = step(params, opt, torch.from_numpy(toks))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-5)
    _assert_leaves_close(param_leaves(params), _jax_leaves(jparams),
                         atol=1e-5)
