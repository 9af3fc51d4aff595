"""The port's loss, gradients and train step against the JAX package's, on
the CPU, with the JAX weights carried over by params_from_jax.

Both sides run attn_impl="flash": in the port the autograd Function, whose
forward and backward are the plain versions on the CPU; in JAX its entry,
which at these lengths takes `_xla_attention`, inside the single-device
shard_map island of its train step. f32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tiny_flash_attention_tpu.models import transformer as JT
from tiny_flash_attention_tpu.parallel.sharded import make_mesh
from tiny_flash_attention_tpu.parallel.train import (
    make_train_step as jax_make_train_step)
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.parallel.train import (
    make_train_step, param_leaves, restore_train_state, save_train_state)

SMALL = dict(vocab_size=128, d_model=128, n_layers=2, n_q_heads=4,
             n_kv_heads=2, d_head=128, d_ff=256)
JCFG = JT.ModelConfig(**SMALL, dtype=jnp.float32)
TCFG = TT.ModelConfig(**SMALL, dtype=torch.float32)


def _params(seed=0):
    jp = JT.init_params(JCFG, jax.random.key(seed))
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp),
                                  device="cpu")


def _tokens(seed, shape=(4, 64)):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], shape).astype(np.int32)


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


def test_params_are_leaves_that_can_require_grad():
    _, tp = _params()
    own = TT.init_params(TCFG, torch.Generator().manual_seed(0),
                         device="cpu")
    for params in (tp, own):
        for t in param_leaves(params):
            assert t.is_leaf and not t.requires_grad
            t.requires_grad_()


def test_loss_and_grads_match_jax():
    jp, tp = _params()
    toks = _tokens(1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(JCFG, p, jnp.asarray(toks)))(jp)
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss = TT.loss_fn(TCFG, tp, torch.from_numpy(toks))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    _assert_leaves_close([t.grad for t in leaves], _jax_leaves(jgrads),
                         atol=1e-5)


def test_sgd_steps_match_jax_train_step():
    """SGD keeps the update linear in the gradients, so three steps hold
    the whole chain (loss, gradients, update) to JAX's at 1e-5."""
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


def test_adamw_steps_match_optax_adamw():
    """Three steps of the default AdamW against JAX's default step
    (optax.adamw). Adam divides by sqrt(g^2): a gradient within rounding
    noise of 0 can move a param by up to lr in either package, so every
    param is held within lr (1e-3), at most one element in 10^4 may differ
    by more than 1e-5, and the losses, which those elements move, agree to
    1e-5 of their value."""
    jp, tp = _params(2)
    jstep, jinit = jax_make_train_step(JCFG, make_mesh(1))
    jparams, jopt = jinit(jp)
    step, init = make_train_step(TCFG, device="cpu")
    params, opt = init(tp)
    losses = []
    toks = _tokens(20)               # one batch: the loss must fall
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(toks))
        params, opt, loss = step(params, opt, torch.from_numpy(toks))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   atol=0)
        losses.append(float(loss))
    got, want = param_leaves(params), _jax_leaves(jparams)
    _assert_leaves_close(got, want, atol=1e-3)
    far = sum(int((np.abs(g.detach().numpy() - w) > 1e-5).sum())
              for g, w in zip(got, want))
    assert far <= sum(w.size for w in want) // 10**4, far
    assert losses[-1] < losses[0]


def test_adamw_update_alone_matches_optax():
    """The default optimizer fed identical gradients: three updates equal
    optax.adamw's at 1e-6, which pins b1, b2, eps and the weight decay of
    1e-4 (torch's own default would be 1e-2)."""
    jp, tp = _params(3)
    _, init = make_train_step(TCFG, learning_rate=1e-2, device="cpu")
    params, opt = init(tp)
    leaves = param_leaves(params)
    tx = optax.adamw(1e-2)
    jleaves = _jax_leaves(jp)
    jstate = tx.init(jleaves)
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = [rng.standard_normal(a.shape).astype(np.float32)
                 for a in jleaves]
        updates, jstate = tx.update(grads, jstate, jleaves)
        jleaves = [np.asarray(a) for a in optax.apply_updates(jleaves,
                                                              updates)]
        for t, g in zip(leaves, grads):
            t.grad = torch.from_numpy(g)
        opt.step()
    _assert_leaves_close(leaves, jleaves, atol=1e-6)


def test_checkpoint_roundtrip_resumes_to_the_same_loss(tmp_path):
    _, tp = _params(5)
    step, init = make_train_step(TCFG, device="cpu")
    params, opt = init(tp)
    toks = [torch.from_numpy(_tokens(30 + i)) for i in range(3)]
    params, opt, _ = step(params, opt, toks[0])
    params, opt, _ = step(params, opt, toks[1])
    save_train_state(str(tmp_path / "ck"), params, opt, step=2)
    _, _, loss_cont = step(params, opt, toks[2])

    fresh = TT.init_params(TCFG, torch.Generator().manual_seed(99),
                           device="cpu")
    r_params, r_opt = init(fresh)
    r_params, r_opt, at = restore_train_state(str(tmp_path / "ck"),
                                              r_params, r_opt)
    assert at == 2
    _, _, loss_resume = step(r_params, r_opt, toks[2])
    assert float(loss_resume) == float(loss_cont)


def test_init_state_leaves_the_callers_params_alone():
    _, tp = _params(6)
    before = [t.clone() for t in param_leaves(tp)]
    step, init = make_train_step(TCFG, device="cpu")
    params, opt = init(tp)
    step(params, opt, torch.from_numpy(_tokens(40)))
    for t, b in zip(param_leaves(tp), before):
        assert not t.requires_grad and torch.equal(t, b)
