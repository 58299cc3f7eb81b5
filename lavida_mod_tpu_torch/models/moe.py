"""Mixture-of-Experts feed-forward block, the port of
lavida_mod_tpu/models/moe.py (the AR baselines llava_mixtral /
llava_qwen_moe).

Dense dispatch as in the JAX package: every token goes through every
expert's SwiGLU, the experts' products batched along an expert axis, and
the router's top-k weights combine them (moe.py:53-81):
  - router logits x @ router in x's dtype, softmax in f32;
  - top-k in `jax.lax.top_k`'s order (descending, ties to the lower
    expert index: a stable sort), the k weights renormalised by their sum
    (at least 1e-9);
  - h = x @ ff_proj[e], u = x @ up_proj[e], y = (silu(h) * u) @ ff_out[e],
    each product rounded to x's dtype, silu in jax.nn.silu's op order;
  - the combine sum_e y[e] * gate[e] in y's dtype, over the experts.
The expert products are plain large matrix products that the JAX package
computes outside any Pallas kernel, so they stay torch.einsum here.

The weights keep the JAX orientation, stacked along the experts: `router`
[D, E], `ff_proj` and `up_proj` [E, D, H], `ff_out` [E, H, D]
(convert.py carries them as they are).  `MoE.forward` returns (out [B, T,
D] in x's dtype, the mean router probability per expert [E] f32, the
load-balancing signal); `load_balancing_loss` is moe.py:84-92.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.activations import silu

TOP_K = 2       # the LLaDA block calls moe_ff with its default (llada.py:354)


def init_moe_params(d_model: int, hidden: int, n_experts: int,
                    generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cpu") -> dict:
    """Seeded N(0, 0.02) weights of one MoE block (moe.py:27-50), in the
    layout of `MoE`'s parameters."""
    def dense(*shape):
        return (torch.randn(*shape, generator=generator, device=device)
                * 0.02).to(dtype)

    return {"router": dense(d_model, n_experts),
            "ff_proj": dense(n_experts, d_model, hidden),
            "up_proj": dense(n_experts, d_model, hidden),
            "ff_out": dense(n_experts, hidden, d_model)}


def top_k_gate(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """[..., E] f32 router probabilities -> [..., E] combine weights: the
    top_k largest (ties to the lower index, as jax.lax.top_k), renormalised
    by their sum, zero elsewhere."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    vals = vals / torch.clamp_min(vals.sum(dim=-1, keepdim=True), 1e-9)
    return torch.zeros_like(probs).scatter_(-1, idx, vals)


def moe_ff(x: torch.Tensor, router: torch.Tensor, ff_proj: torch.Tensor,
           up_proj: torch.Tensor, ff_out: torch.Tensor, top_k: int = TOP_K,
           router_jitter: Optional[torch.Tensor] = None):
    """Top-k softmax routing over dense-dispatched experts (moe.py:53-81).
    x [B, T, D] -> (out [B, T, D], mean router probability [E] f32)."""
    logits = x @ router                                       # [B, T, E]
    if router_jitter is not None:
        logits = logits + router_jitter
    probs = torch.softmax(logits.float(), dim=-1)
    gate = top_k_gate(probs, top_k)                           # [B, T, E]
    h = torch.einsum("btd,edh->beth", x, ff_proj)
    u = torch.einsum("btd,edh->beth", x, up_proj)
    y = torch.einsum("beth,ehd->betd", silu(h) * u, ff_out)   # [B, E, T, D]
    out = torch.einsum("betd,bte->btd", y, gate.to(y.dtype))
    return out.to(x.dtype), probs.mean(dim=(0, 1))


def load_balancing_loss(router_probs_mean: torch.Tensor,
                        top_fraction: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Switch-style aux loss E * sum(f_e * p_e); without the expert
    fractions the mean-prob proxy E * sum(p_e^2) (moe.py:84-92)."""
    E = router_probs_mean.shape[0]
    if top_fraction is None:
        return E * torch.sum(router_probs_mean * router_probs_mean)
    return E * torch.sum(top_fraction * router_probs_mean)


class MoE(nn.Module):
    """One block's experts and router (a block's `moe`, llada.py:350-356)."""

    def __init__(self, d_model: int, hidden: int, n_experts: int, device,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d_model, n_experts, **kw))
        self.ff_proj = nn.Parameter(torch.empty(n_experts, d_model, hidden,
                                                **kw))
        self.up_proj = nn.Parameter(torch.empty(n_experts, d_model, hidden,
                                                **kw))
        self.ff_out = nn.Parameter(torch.empty(n_experts, hidden, d_model,
                                               **kw))

    @property
    def n_experts(self) -> int:
        return self.router.shape[1]

    @property
    def hidden(self) -> int:
        return self.ff_proj.shape[2]

    def forward(self, x: torch.Tensor, top_k: int = TOP_K,
                router_jitter: Optional[torch.Tensor] = None):
        return moe_ff(x, self.router, self.ff_proj, self.up_proj,
                      self.ff_out, top_k, router_jitter)
