"""Entry points whose JAX counterpart has no gradient.

In JAX each of the port's forward-only kernels is a `pallas_call` without a
VJP, so `jax.grad` through it raises. On CUDA the port's wrappers launch
their kernels through `forward_only`, so a `backward()` through them raises
too instead of silently dropping the gradient. Serving (grad off, or no
input that requires grad) pays nothing.
"""

from __future__ import annotations

import torch


class _ForwardOnly(torch.autograd.Function):
    """Its forward runs `launch()`; its backward raises."""

    @staticmethod
    def forward(ctx, what: str, launch, *inputs):
        ctx.what = what
        return launch()

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.what} has no backward, as in JAX (its kernel has no VJP)")


def forward_only(what: str, launch, *inputs):
    """`launch()`'s result; when grad is enabled and one of `inputs`
    requires grad, through a Function whose backward raises
    NotImplementedError naming `what`."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        return _ForwardOnly.apply(what, launch, *inputs)
    return launch()
