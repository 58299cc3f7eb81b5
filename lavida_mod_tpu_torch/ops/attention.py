"""Attention ops: the port of lavida_mod_tpu/ops/attention.py.

  - `dense_attention`: non-causal GQA attention with an optional additive
    bias, in plain PyTorch (the JAX package leaves it to XLA).  GQA is a
    reshape of the queries into [kv_heads, groups], never a repeat of K/V;
    scores and softmax are f32; probabilities are cast to v's dtype before
    the PV product.  Serves the decode steps over the bf16 KV cache and
    the dense training attention (make_bias's prefix-LM mask).
  - `blockwise_attention`: the memory-bounded training attention, an
    online softmax over key blocks with the prefix-LM and key-padding
    masks built per block (plain XLA in the JAX package, so torch ops are
    its port);
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
from torch.utils.checkpoint import checkpoint

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


def _key_block(q, kb, vb, valid, start, m, l, acc, prefix_lengths,
               q_positions, scale):
    """One key block of `blockwise_attention` (attention.py:241-264):
    scores, the block's mask, the running max / sum / accumulator."""
    B, T, Hkv, G, hd = q.shape
    blk = kb.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * T, hd)
    kt = kb.permute(0, 2, 3, 1).reshape(B * Hkv, hd, blk)
    s = bmm_f32(qf, kt).view(B, Hkv, G, T, blk) * scale
    allowed = valid[:, None, :]                         # [B, 1, blk]
    if prefix_lengths is not None:
        kv_pos = start + torch.arange(blk, device=q.device)
        pl = prefix_lengths.to(torch.int32)[:, None, None]
        allowed = allowed & ((kv_pos[None, None, :] < pl)
                             | (q_positions[None, :, None] >= pl))
    else:
        allowed = allowed.expand(B, T, blk)
    s = torch.where(allowed[:, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    vt = vb.permute(0, 2, 1, 3).reshape(B * Hkv, blk, hd)
    pv = bmm_f32(p.to(vb.dtype).reshape(B * Hkv, G * T, blk), vt)
    pv = pv.view(B, Hkv, G, T, hd).permute(0, 3, 1, 2, 4)
    acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l, acc


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_valid: torch.Tensor | None = None,
    prefix_lengths: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    scale: float | None = None,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Memory-bounded attention (attention.py:182-270): an online softmax
    over key blocks of `kv_block` rows, flash attention's algorithm in
    plain tensor ops.  kv_valid [B, S] bool, prefix_lengths [B] (allowed =
    kv in the prefix or q in the suffix, over sequence indices),
    q_positions [T] (default arange).  Shapes as dense_attention; returns
    [B, T, Hq, hd] in q's dtype.  The masks are built per block and, while
    autograd records, each block's step is checkpointed, so neither the
    forward nor the backward holds anything O(T x S): a block's scores
    are recomputed in the backward from its (max, sum, accumulator)."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"blockwise_attention: {Hq} q heads over {Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / hd ** 0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(T, device=dev)
    nb = -(-S // kv_block)
    pad = nb * kv_block - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    valid = (torch.ones(B, S, dtype=torch.bool, device=dev)
             if kv_valid is None else kv_valid.to(torch.bool))
    if pad:
        valid = torch.nn.functional.pad(valid, (0, pad))
    qg = q.reshape(B, T, Hkv, G, hd)
    m = torch.full((B, Hkv, G, T), NEG_INF, device=dev)
    l = torch.zeros(B, Hkv, G, T, device=dev)
    acc = torch.zeros(B, T, Hkv, G, hd, device=dev)
    record = torch.is_grad_enabled()
    for i in range(nb):
        lo = i * kv_block
        args = (qg, k[:, lo:lo + kv_block], v[:, lo:lo + kv_block],
                valid[:, lo:lo + kv_block], lo, m, l, acc, prefix_lengths,
                q_positions, scale)
        m, l, acc = (checkpoint(_key_block, *args, use_reentrant=False)
                     if record else _key_block(*args))
    out = acc / l.clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, Hq, hd).to(q.dtype)


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
