"""The dense layer of the vision towers, the resamplers and the projector,
in JAX's rounding."""

import torch
from torch import nn


def linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    """`x @ kernel + bias` as JAX writes it: the product rounded to x's
    dtype, then the bias added (F.linear's addmm rounds once)."""
    y = x @ m.weight.t()
    return y if m.bias is None else y + m.bias
