"""Normalization ops with the JAX package's precision boundaries
(lavida_mod_tpu/ops/norms.py): statistics in float32, the normalized value
cast back to the input dtype, then the affine in that dtype (one rounding
per multiply and per add, as XLA does it)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-5, gemma: bool = False) -> torch.Tensor:
    """RMSNorm (modeling_llada.py:339-353 via norms.py:14-26); `gemma`:
    the affine is (1 + weight) (modeling_llada.py:370-384)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is None:
        return out
    return out * ((1.0 + weight) if gemma else weight)


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


NORM_TYPES = ("rms", "gemma_rms", "default", "low_precision")


def apply_norm(x: torch.Tensor, weight: torch.Tensor | None, norm_type: str,
               rms_eps: float = 1e-5, ln_eps: float = 1e-5) -> torch.Tensor:
    """`apply_norm` (norms.py:44-55): the LM's norm by LayerNormType,
    weight only (the LM's norms carry no bias); "default" and
    "low_precision" are the same LayerNorm there."""
    if norm_type == "rms":
        return rms_norm(x, weight, rms_eps)
    if norm_type == "gemma_rms":
        return rms_norm(x, weight, rms_eps, gemma=True)
    if norm_type in ("default", "low_precision"):
        return layer_norm(x, weight, None, ln_eps)
    raise NotImplementedError(norm_type)
