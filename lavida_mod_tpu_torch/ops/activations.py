"""Activations in the op order of jax.nn, each op in the input's dtype.

In bf16 every step of jax.nn.gelu and jax.nn.silu rounds (its Python
constants become bf16 constants too); PyTorch's fused F.gelu / F.silu
compute in f32 and round once.  Writing the steps out keeps the port's
bf16 results equal to the JAX package's where XLA keeps each rounding.
"""

from __future__ import annotations

import math

import torch


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=False)."""
    return 0.5 * x * torch.special.erfc(-x * _const(math.sqrt(0.5), x))


class _Silu(torch.autograd.Function):
    """x * (1 / (1 + exp(-x))) with autograd's own backward of those ops,
    op for op, except where exp(-x) overflows: there autograd's chain
    multiplies a zero by inf (NaN), and the derivative, x e / (1 + e)^2,
    is 0.  jax.nn.silu's gradient (through lax.logistic) is finite there
    too."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(-x)
        s = 1.0 / (1.0 + e)
        ctx.save_for_backward(x, s, e)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s, e = ctx.saved_tensors
        ge = (-(g * x) * (s * s)) * e      # reciprocal's, then exp's
        ge = torch.where(torch.isinf(e), 0.0, ge)
        return g * s - ge


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * (1 / (1 + exp(-x)))."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Silu.apply(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))
