"""LLaDA: the bidirectional (non-causal) diffusion-LM transformer, ported
from lavida_mod_tpu/models/llada.py for the serving slice.

Covered: the "llama" block (separate q/k/v projections, SwiGLU as
silu(ff_proj) * up_proj, RMSNorm, RoPE) that LLaDA-8B uses, with the layers
in a list (the JAX package's unrolled inference layout), and the forward
paths the slice runs:
  - a full forward over the input, optionally returning each layer's
    rotated K and V;
  - prefill with kv_write_index=0 into preallocated [B, P+G] buffers, the
    G unwritten rows masked by the filled-rows mask (llada.py:465-491),
    attention through the short-attention kernel with segment ids built
    from that mask (llada.py:537-548);
  - decode with kv_write_index=P and dense attention (llada.py:296-329);
  - the f32 logits head (llada.py:700-708).
The cache holds keys rotated once at write time, as in the JAX package.

The "sequential"/fused layouts, quantized leaves, the int8 KV cache,
scan/remat and the prefix-flash training attention raise
NotImplementedError here; ROADMAP.md queues them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lavida_mod_tpu.config import LLaDAConfig

from ..ops.attention import bmm_f32, dense_attention, flash_attention, make_bias
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_tables

def check_supported(cfg: LLaDAConfig) -> None:
    """Raise NotImplementedError for a config outside this slice."""
    unsupported = {
        "block_type": cfg.block_type != "llama",
        "activation": cfg.activation != "silu",
        "layer_norm_type": cfg.layer_norm_type != "rms",
        "rope": not cfg.rope,
        "attention_layer_norm": cfg.attention_layer_norm,
        "include_qkv_bias": cfg.include_qkv_bias,
        "input_emb_norm": cfg.input_emb_norm,
        "scale_logits": cfg.scale_logits,
        "weight_tying": cfg.weight_tying,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"LLaDA port covers the llama/silu/rms block with untied head "
            f"and rope only; unsupported: {bad}")


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LLaDABlock(nn.Module):
    """One llama-layout block (llada.py:219-362)."""

    def __init__(self, cfg: LLaDAConfig, device, dtype=None):
        super().__init__()
        D, H = cfg.d_model, cfg.hidden_size
        kvD = cfg.effective_n_kv_heads * cfg.head_dim
        lin = dict(bias=False, device=device, dtype=dtype)
        self.cfg = cfg
        self.attn_norm = RMSNorm(D, cfg.rms_norm_eps, device, dtype)
        self.ff_norm = RMSNorm(D, cfg.rms_norm_eps, device, dtype)
        self.q_proj = nn.Linear(D, D, **lin)
        self.k_proj = nn.Linear(D, kvD, **lin)
        self.v_proj = nn.Linear(D, kvD, **lin)
        self.attn_out = nn.Linear(D, D, **lin)
        self.ff_proj = nn.Linear(D, H, **lin)
        self.up_proj = nn.Linear(D, H, **lin)
        self.ff_out = nn.Linear(H, D, **lin)

    def forward(self, x, *, sin, cos, positions, bias, layer_past,
                kv_write_index, use_flash, q_seg, kv_seg):
        """x [B, T, D] -> (x, (k, v)).  With `layer_past` (preallocated
        [B, S, Hkv, hd] buffers) this call's rotated k and v are written
        IN PLACE at rows [kv_write_index, kv_write_index + T) -- the JAX
        package's dynamic_update_slice, without its functional copy -- and
        attention reads the whole buffers."""
        cfg = self.cfg
        B, T, D = x.shape
        Hq, Hkv, hd = cfg.n_heads, cfg.effective_n_kv_heads, cfg.head_dim
        h = self.attn_norm(x)
        q = self.q_proj(h).view(B, T, Hq, hd)
        k = self.k_proj(h).view(B, T, Hkv, hd)
        v = self.v_proj(h).view(B, T, Hkv, hd)
        q = apply_rope(q, positions, sin, cos, cfg.rope_full_precision)
        k = apply_rope(k, positions, sin, cos, cfg.rope_full_precision)
        if layer_past is not None:
            pk, pv = layer_past
            pk[:, kv_write_index:kv_write_index + T].copy_(k)
            pv[:, kv_write_index:kv_write_index + T].copy_(v)
            k, v = pk, pv
        if use_flash:
            att = flash_attention(q, k, v, q_seg, kv_seg)
        else:
            att = dense_attention(q, k, v, bias=bias)
        x = x + self.attn_out(att.reshape(B, T, D))
        h2 = self.ff_norm(x)
        x = x + self.ff_out(F.silu(self.ff_proj(h2)) * self.up_proj(h2))
        return x, (k, v)


class LLaDA(nn.Module):
    """Embedding, blocks, final RMSNorm and the untied f32 logits head."""

    def __init__(self, cfg: LLaDAConfig, device, dtype=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        D, E = cfg.d_model, cfg.num_embeddings
        self.wte = nn.Embedding(E, D, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            LLaDABlock(cfg, device, dtype) for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(D, cfg.rms_norm_eps, device, dtype)
        self.ff_out = nn.Linear(D, E, bias=False, device=device,
                                dtype=dtype)
        self._rope_key = None
        self._rope = None

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """wte lookup (modeling_llada.py:1283)."""
        return self.wte(ids)

    def _rope_tables(self, length: int, device: torch.device):
        key = (length, device)
        if self._rope_key != key:
            cfg = self.cfg
            self._rope = rope_tables(cfg.head_dim, length, cfg.rope_theta,
                                     device)
            self._rope_key = key
        return self._rope

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """ln_f, then the head with an f32 result from the model-dtype
        weight (XLA's preferred_element_type=f32): on CUDA the bf16 tensor
        cores accumulate and write f32 (torch.bmm out_dtype), so no f32
        copy of the 2 GB head is kept and logits are never rounded to
        bf16, which would create confidence ties."""
        x = self.ln_f(x)
        B, T, D = x.shape
        w = self.ff_out.weight
        return bmm_f32(x.reshape(1, B * T, D), w.t()[None]).view(B, T, -1)

    def forward(
        self,
        embeds: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        kv_cache: Optional[list] = None,
        kv_valid: Optional[torch.Tensor] = None,
        self_valid: Optional[torch.Tensor] = None,
        kv_write_index: Optional[int] = None,
        use_cache: bool = False,
        return_logits: bool = True,
        use_flash: bool = False,
    ):
        """Run the blocks on input embeddings [B, T, D].

        positions: [T] absolute RoPE positions (default: the row indices,
          offset by kv_write_index).
        kv_cache: per-layer preallocated (k, v) buffers [B, S, Hkv, hd];
          requires kv_write_index (a host int), where this call's rows are
          written in place; keys at or past kv_write_index + T are masked.
        kv_valid: [B, S] bool over the buffer rows; self_valid: [B, T]
          bool over this call's rows.
        use_flash: attention through the short-attention kernel, masked by
          segment ids; otherwise dense attention with an additive bias.

        Returns (logits [B, T, V] f32, or ln_f(hidden) [B, T, D] when
        return_logits is False; the per-layer (k, v) list when use_cache,
        else None).
        """
        B, T, _ = embeds.shape
        device = embeds.device
        if kv_cache is not None:
            if kv_write_index is None:
                raise NotImplementedError(
                    "kv_cache needs kv_write_index: only preallocated "
                    "buffers written in place are ported")
            S = kv_cache[0][0].shape[1]
            start = kv_write_index
        elif kv_write_index is not None or kv_valid is not None:
            raise ValueError("kv_write_index / kv_valid need a kv_cache")
        else:
            S, start = T, 0
        if positions is None:
            positions = torch.arange(start, start + T, device=device)
        sin, cos = self._rope_tables(max(self.cfg.max_sequence_length, S),
                                     device)

        valid = self_valid
        if kv_cache is not None:
            filled = torch.arange(S, device=device) < kv_write_index + T
            valid = filled[None].expand(B, S)
            if kv_valid is not None:
                valid = valid & kv_valid
        bias = q_seg = kv_seg = None
        if use_flash:
            if valid is not None:
                kv_seg = valid.to(torch.int32).contiguous()
                sv = (self_valid if self_valid is not None
                      else torch.ones(B, T, dtype=torch.bool, device=device))
                q_seg = sv.to(torch.int32).contiguous()
        elif valid is not None:
            bias = make_bias(kv_valid=valid)

        x = embeds
        presents = []
        for li, block in enumerate(self.blocks):
            x, present = block(
                x, sin=sin, cos=cos, positions=positions, bias=bias,
                layer_past=None if kv_cache is None else kv_cache[li],
                kv_write_index=kv_write_index, use_flash=use_flash,
                q_seg=q_seg, kv_seg=kv_seg)
            if use_cache:
                presents.append(present)
        new_cache = presents if use_cache else None
        if not return_logits:
            return self.ln_f(x), new_cache
        return self.logits(x), new_cache
