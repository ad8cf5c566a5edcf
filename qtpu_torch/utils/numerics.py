"""Correctly rounded float32 arithmetic where PyTorch's CPU kernels are not.

qtpu folds BatchNorm with ``jnp.sqrt``, which XLA rounds correctly on every
device.  PyTorch's float32 ``torch.sqrt`` on the CPU (its vectorised AVX-512
path) misses the correctly rounded root by one ulp on a fraction of inputs
(about 0.6% of uniform ones), while the card's is correctly rounded.  A
fold factor ``γ / sqrt(var + eps)`` one ulp apart moves a folded weight
across a rounding tie now and then, and so a weight code (ROADMAP C13,
C22).  :func:`sqrt_rn` is the square root every BatchNorm fold and
normalisation of the port takes.
"""
from __future__ import annotations

import torch


class _SqrtRN(torch.autograd.Function):
    """float32 forward through float64; JAX's float32 backward."""

    @staticmethod
    def forward(ctx, x):
        # the float64 root of a float32 input, rounded once to float32: a
        # square root from 53 to 24 bits cannot double-round, so this is the
        # correctly rounded float32 root on every device
        y = torch.sqrt(x.to(torch.float64)).to(x.dtype)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        # jax's jvp of sqrt, g · (0.5 / y) in the operand's dtype: 0.5 / y is
        # the correctly rounded 1 / y halved, exactly
        return g * (y.reciprocal() * 0.5)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor (any other
    dtype: ``torch.sqrt``), with ``jax.grad(jnp.sqrt)``'s gradient."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    return _SqrtRN.apply(x)
