"""Normalization ops with the JAX package's precision boundaries
(lavida_mod_tpu/ops/norms.py): statistics in float32, the normalized value
cast back to the input dtype, then the affine in that dtype (one rounding
per multiply and per add, as XLA does it)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (modeling_llada.py:339-353 via norms.py:14-26)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return out if weight is None else out * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with population variance (norms.py:29-41)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
