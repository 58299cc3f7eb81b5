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


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * (1 / (1 + exp(-x)))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))
