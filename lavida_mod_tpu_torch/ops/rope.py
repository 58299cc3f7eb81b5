"""Rotary position embeddings, half-rotation layout (the port of
lavida_mod_tpu/ops/rope.py, reference modeling_llada.py:387-452).

sin/cos are duplicated by concatenation (not interleaved), rotate_half
splits the head dim into two contiguous halves, and the rotation runs in
float32 when `full_precision`.  Keys are rotated once, when they are
written to the cache, at their absolute positions."""

from __future__ import annotations

import torch


def rope_tables(head_dim: int, max_len: int, theta: float,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos), each [max_len, head_dim] float32 on `device`."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = pos[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor, full_precision: bool = True) -> torch.Tensor:
    """Rotate x [B, T, H, hd] at absolute positions [T]."""
    s = sin[positions][None, :, None, :]
    c = cos[positions][None, :, None, :]
    xr = x.float() if full_precision else x
    return (xr * c + _rotate_half(xr) * s).to(x.dtype)
