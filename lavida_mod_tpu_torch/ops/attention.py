"""Attention ops: the port of lavida_mod_tpu/ops/attention.py.

  - `dense_attention`: non-causal GQA attention with an optional additive
    bias, in plain PyTorch (the JAX package leaves it to XLA).  GQA is a
    reshape of the queries into [kv_heads, groups], never a repeat of K/V;
    scores and softmax are f32; probabilities are cast to v's dtype before
    the PV product.  Serves the decode steps over the bf16 KV cache and
    the dense training attention (make_bias's prefix-LM mask).
  - `flash_attention` and `vision_attention`: the segment-masked and the
    unmasked entry points of the short-attention kernel
    (ops/short_attention.py), which runs on CUDA and falls to its plain
    version only for CPU tensors.  Its online softmax has no length cap,
    so every S routes there (the JAX package sends padded S > 4096 to
    JAX's own TPU flash kernel instead).

Bias convention: additive f32 broadcastable to [B, H, T, S]; 0 = attend,
NEG_INF = masked, kept finite so a fully masked row stays finite.
"""

from __future__ import annotations

import torch

from .short_attention import short_attention

NEG_INF = -1e30


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with an f32 result, as XLA's
    `preferred_element_type=f32`: on CUDA, bf16/fp16 inputs go to the
    tensor cores with f32 accumulation and output; elsewhere, and where
    autograd records (the out_dtype product has no derivative), the inputs
    are upcast (exact: a product of two bf16 values fits in f32)."""
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype != torch.float32 and not grad:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """q [B, T, Hq, hd]; k, v [B, S, Hkv, hd]; Hq % Hkv == 0; bias
    broadcastable to [B, Hq or 1, T, S].  Returns [B, T, Hq, hd] in q's
    dtype."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"dense_attention: {Hq} q heads over {Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / hd ** 0.5
    qg = q.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B * Hkv, G * T, hd)
    kt = k.permute(0, 2, 3, 1).reshape(B * Hkv, hd, S)
    scores = bmm_f32(qg, kt).view(B, Hkv, G, T, S) * scale
    if bias is not None:
        bias = bias.float()
        if bias.shape[1] == 1:
            bias = bias[:, :, None]
        else:
            bias = bias.reshape(bias.shape[0], Hkv, G, *bias.shape[2:])
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    vt = v.permute(0, 2, 1, 3).reshape(B * Hkv, S, hd)
    out = torch.bmm(probs.reshape(B * Hkv, G * T, S), vt)
    out = out.view(B, Hkv, G, T, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, Hq, hd).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment-masked attention through the short-attention kernel: tokens
    attend only to keys of an equal segment id.  q [B, T, Hq, hd]; k, v
    [B, S, Hkv, hd]; ids [B, T] / [B, S] int32 or both None."""
    return short_attention(q, k, v, segment_ids_q, segment_ids_kv)


def vision_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Unmasked bidirectional attention for the vision tower: the kernel
    on CUDA, its plain version on the CPU."""
    return short_attention(q, k, v)


def make_bias(
    kv_valid: torch.Tensor | None = None,
    prefix_lengths: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
) -> torch.Tensor | None:
    """Additive attention bias, [B, 1, T or 1, S] f32, or None.

    kv_valid: [B, S] bool key-padding mask (True = attend).
    prefix_lengths: [B] prefix-LM block mask (modeling_llada.py:1358-1364):
      allowed(q, kv) = kv_pos < prefix_len or q_pos >= prefix_len; needs
      q_positions [T] and kv_positions [S].
    """
    bias = None
    if kv_valid is not None:
        bias = torch.where(kv_valid[:, None, None, :], 0.0, NEG_INF)
    if prefix_lengths is not None:
        if q_positions is None or kv_positions is None:
            raise ValueError("make_bias: prefix_lengths needs q_positions "
                             "and kv_positions")
        pl = prefix_lengths.to(torch.int32)[:, None, None, None]
        allowed = ((kv_positions.reshape(1, 1, 1, -1) < pl)
                   | (q_positions.reshape(1, 1, -1, 1) >= pl))
        b2 = torch.where(allowed, 0.0, NEG_INF)
        bias = b2 if bias is None else torch.clamp(bias + b2, min=NEG_INF)
    return bias
