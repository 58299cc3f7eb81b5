"""LLaDA: the bidirectional (non-causal) diffusion-LM transformer, ported
from lavida_mod_tpu/models/llada.py for the serving and training slices.

Covered: the "llama" block (separate q/k/v projections, SwiGLU as
silu(ff_proj) * up_proj, RMSNorm, RoPE) that LLaDA-8B uses, and the fused
"sequential" block `to_fused_layout` makes of it (att_proj = [q|k|v],
ff_proj = [up|gate] chunked by the swiglu activation, llada.py:111-124,
719-752), with the layers in a list (the JAX package's unrolled inference
layout, `unstack_blocks`), and the forward paths the slices run:
  - a full forward over the input, optionally returning each layer's
    rotated K and V;
  - prefill with kv_write_index=0 into preallocated [B, P+G] buffers, the
    G unwritten rows masked by the filled-rows mask (llada.py:465-491),
    attention through the short-attention kernel with segment ids built
    from that mask (llada.py:537-548);
  - decode with kv_write_index=P and dense attention (llada.py:296-329);
  - the f32 logits head (llada.py:700-708).
The cache holds keys rotated once at write time, as in the JAX package.

Quantized serving (`quantize`, `add_prefill_tree`; llada.py:807-866): a
linear may be an `Int8Linear` or an `Int4Linear` (ops/quant.py).  With
`act_int8` the blocks run their int8 prefill tree, when one is attached,
through the W8A8 kernel.  A block whose four linears are unpadded int4 in
the sequential/swiglu layout runs decode-sized rows (<= 32, a multiple of
8) through the three fused W4A8 kernels (`fused_plan`, llada.py:142-197),
and an int4 head through `w4_qkv_norm` on ln_f, its logits rounded to
bf16 and then cast to f32 as in the JAX package (`head_fusable`,
llada.py:200-216, 684-699).  Unlike the JAX package the plans engage on
the CPU too, where the ops run their plain versions.

With an int8 KV cache (a per-layer 4-tuple (k8, ks, v8, vs) in the
head-major layout of ops/kv8_attention.py, llada.py:285-295) each decode
call quantizes its rows into the buffers in place (`write_rows`) and
attends through `kv8_decode_attention` (kernel #8) under the filled-rows
and padding mask.

Training (llada.py:407-667 on the list-of-layers model): `forward` takes
`prefix_lengths` [B], the prefix-LM block mask over SEQUENCE indices (never
the RoPE `positions`, which training may shift), and `attention_impl`:
"dense" builds make_bias's additive mask, "prefix_flash" runs the fused
prefix-LM kernel #10 (ops/prefix_flash.py, plen 0 when none is given) and
"auto" picks prefix_flash on CUDA and dense on the CPU, as train.py's
--attn-impl auto picks by backend.  `remat="whole_layer"` (or True)
checkpoints each block (torch.utils.checkpoint), keeping the layer
boundaries and recomputing the inside in the backward; the JAX package's
"nested", "dots", "dots_nobatch" and "one_in_N" strategies raise
NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LLaDAConfig, as_port_config

from ..ops.activations import silu
from ..ops.attention import bmm_f32, dense_attention, flash_attention, make_bias
from ..ops.kv8_attention import kv8_decode_attention, write_rows
from ..ops.norms import rms_norm
from ..ops.prefix_flash import prefix_flash_attention
from ..ops.quant import Int4Linear, Int8Linear, quantize_module
from ..ops.rope import apply_rope, rope_tables
from ..ops.w4_fused import w4_ffn_fused, w4_matmul_res, w4_qkv_norm

_LAYOUTS = {"llama": "silu", "sequential": "swiglu"}
_LINEARS = {"llama": ("q_proj", "k_proj", "v_proj", "attn_out", "ff_proj",
                      "up_proj", "ff_out"),
            "sequential": ("att_proj", "attn_out", "ff_proj", "ff_out")}


def check_supported(cfg: LLaDAConfig) -> None:
    """Raise NotImplementedError for a config outside the port."""
    unsupported = {
        "block_type": cfg.block_type not in _LAYOUTS,
        "activation": _LAYOUTS.get(cfg.block_type) != cfg.activation,
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
            f"LLaDA port covers the llama/silu and sequential/swiglu rms "
            f"blocks with untied head and rope only; unsupported: {bad}")


def remat_layers(remat) -> bool:
    """Whether an activation-checkpointing strategy checkpoints each layer
    (`_remat_group`, llada.py:368-394): False / None / "none" no, True /
    "whole_layer" yes; the others are not ported."""
    if remat in (False, None, "none"):
        return False
    if remat in (True, "whole_layer"):
        return True
    raise NotImplementedError(
        f"activation checkpointing {remat!r}: the port has whole_layer only "
        f"(nested, dots, dots_nobatch and one_in_N are ROADMAP work)")


def _block_n(*ns: int) -> Optional[int]:
    """llada.py:137-139: the largest of 512/256/128 dividing every n."""
    return next((b for b in (512, 256, 128)
                 if all(n % b == 0 for n in ns)), None)


def _run_linear(m: nn.Module, x: torch.Tensor, act_int8: bool = False,
                preferred=None) -> torch.Tensor:
    """`linear` / `linear_act_int8` (quant.py:170-230) on any linear kind."""
    if isinstance(m, nn.Linear):
        return m(x)
    return m(x, act_int8=act_int8, preferred=preferred)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LLaDABlock(nn.Module):
    """One block (llada.py:219-362) in the llama or the sequential layout.
    `prefill`, when set, is a ModuleDict of the int8 twins of the linears
    that `act_int8` forwards use (the mixed layout's prefill tree); the
    norms are shared with the decode linears."""

    def __init__(self, cfg: LLaDAConfig, device, dtype=None):
        super().__init__()
        D, H = cfg.d_model, cfg.hidden_size
        kvD = cfg.effective_n_kv_heads * cfg.head_dim
        lin = dict(bias=False, device=device, dtype=dtype)
        self.cfg = cfg
        self.attn_norm = RMSNorm(D, cfg.rms_norm_eps, device, dtype)
        self.ff_norm = RMSNorm(D, cfg.rms_norm_eps, device, dtype)
        self.attn_out = nn.Linear(D, D, **lin)
        if cfg.block_type == "llama":
            self.q_proj = nn.Linear(D, D, **lin)
            self.k_proj = nn.Linear(D, kvD, **lin)
            self.v_proj = nn.Linear(D, kvD, **lin)
            self.ff_proj = nn.Linear(D, H, **lin)
            self.up_proj = nn.Linear(D, H, **lin)
            self.ff_out = nn.Linear(H, D, **lin)
        else:
            self.att_proj = nn.Linear(D, D + 2 * kvD, **lin)
            self.ff_proj = nn.Linear(D, H, **lin)         # [up | gate]
            self.ff_out = nn.Linear(H // 2, D, **lin)
        self.prefill: Optional[nn.ModuleDict] = None

    @property
    def linear_names(self) -> tuple[str, ...]:
        return _LINEARS[self.cfg.block_type]

    def _lin(self, name: str, x: torch.Tensor, act_int8: bool):
        if act_int8 and self.prefill is not None:
            return self.prefill[name](x, act_int8=True)
        return _run_linear(getattr(self, name), x, act_int8)

    def fused_plan(self, rows: int, act_int8: bool) -> bool:
        """`_w4_fused_plan` (llada.py:142-197) as a geometry gate: the
        sequential/swiglu layout, decode-sized rows, four unpadded int4
        linears whose widths the TPU kernels' blocks divide."""
        cfg = self.cfg
        if act_int8 or cfg.block_type != "sequential":
            return False
        if rows > 32 or rows % 8:
            return False
        lins = [getattr(self, n) for n in self.linear_names]
        if not all(isinstance(m, Int4Linear) and not m.padded for m in lins):
            return False
        D = self.att_proj.scales.shape[0] * 128
        Nqkv = self.att_proj.scales.shape[1]
        H2 = self.ff_proj.scales.shape[1]
        Hd = self.ff_out.scales.shape[0] * 128
        if Hd < H2 // 2 or D > 4096 or self.attn_out.scales.shape[1] != D:
            return False
        return (_block_n(Nqkv, D) is not None
                and _block_n(H2, H2 // 2, Hd, D) is not None)

    def forward(self, x, *, sin, cos, positions, bias, layer_past,
                kv_write_index, use_flash, q_seg, kv_seg, act_int8=False,
                kv8_valid=None, prefix_flash=None):
        """x [B, T, D] -> (x, (k, v)).  With `layer_past` (preallocated
        [B, S, Hkv, hd] buffers) this call's rotated k and v are written
        IN PLACE at rows [kv_write_index, kv_write_index + T) -- the JAX
        package's dynamic_update_slice, without its functional copy -- and
        attention reads the whole buffers.  A 4-tuple `layer_past` is the
        int8 cache: the rows are quantized into it and attention runs the
        kv8 kernel masked by `kv8_valid` [B, S]; the present is the
        4-tuple."""
        cfg = self.cfg
        B, T, D = x.shape
        Hq, Hkv, hd = cfg.n_heads, cfg.effective_n_kv_heads, cfg.head_dim
        eps = cfg.rms_norm_eps
        fused = self.fused_plan(B * T, act_int8)
        if fused:
            qkv = w4_qkv_norm(x.reshape(B * T, D), self.attn_norm.weight,
                              self.att_proj.packed, self.att_proj.scales,
                              eps).view(B, T, -1)
            q, k, v = qkv.split([D, Hkv * hd, Hkv * hd], dim=-1)
        elif cfg.block_type == "llama":
            h = self.attn_norm(x)
            q = self._lin("q_proj", h, act_int8)
            k = self._lin("k_proj", h, act_int8)
            v = self._lin("v_proj", h, act_int8)
        else:
            qkv = self._lin("att_proj", self.attn_norm(x), act_int8)
            q, k, v = qkv.split([D, Hkv * hd, Hkv * hd], dim=-1)
        q = apply_rope(q.reshape(B, T, Hq, hd), positions, sin, cos,
                       cfg.rope_full_precision)
        k = apply_rope(k.reshape(B, T, Hkv, hd), positions, sin, cos,
                       cfg.rope_full_precision)
        v = v.reshape(B, T, Hkv, hd)
        if layer_past is not None and len(layer_past) == 4:
            if kv_write_index is None or use_flash:
                raise ValueError("the int8 KV cache is a decode cache: it "
                                 "needs kv_write_index and no flash")
            present = write_rows(*layer_past, k, v, kv_write_index)
            att = kv8_decode_attention(q, *present, kv_valid=kv8_valid)
        else:
            if layer_past is not None:
                pk, pv = layer_past
                pk[:, kv_write_index:kv_write_index + T].copy_(k)
                pv[:, kv_write_index:kv_write_index + T].copy_(v)
                k, v = pk, pv
            present = (k, v)
            if prefix_flash is not None:
                att = prefix_flash_attention(q, k, v, *prefix_flash)
            elif use_flash:
                att = flash_attention(q, k, v, q_seg, kv_seg)
            else:
                att = dense_attention(q, k, v, bias=bias)
        if fused:
            x2 = w4_matmul_res(att.reshape(B * T, D).contiguous(),
                               x.reshape(B * T, D), self.attn_out.packed,
                               self.attn_out.scales)
            x = w4_ffn_fused(x2, self.ff_norm.weight, self.ff_proj.packed,
                             self.ff_proj.scales, self.ff_out.packed,
                             self.ff_out.scales, eps).view(B, T, D)
            return x, present
        x = x + self._lin("attn_out", att.reshape(B, T, D), act_int8)
        h2 = self.ff_norm(x)
        if cfg.block_type == "llama":
            # jax.nn.silu's op order (ops/activations.py): in bf16 it
            # rounds where PyTorch's fused F.silu does not
            ff = (silu(self._lin("ff_proj", h2, act_int8))
                  * self._lin("up_proj", h2, act_int8))
        else:
            # swiglu chunks (xx, gate) and returns silu(gate) * xx
            xx, gate = self._lin("ff_proj", h2, act_int8).chunk(2, dim=-1)
            ff = silu(gate) * xx
        x = x + self._lin("ff_out", ff, act_int8)
        return x, present


class LLaDA(nn.Module):
    """Embedding, blocks, final RMSNorm and the untied logits head."""

    def __init__(self, cfg: LLaDAConfig, device, dtype=None):
        super().__init__()
        cfg = as_port_config(cfg)
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

    def head_fusable(self, rows: int) -> bool:
        """`_w4_head_fusable` (llada.py:200-216): an int4 head over d_model
        <= 4096 and decode-sized rows."""
        head, D = self.ff_out, self.cfg.d_model
        return (isinstance(head, Int4Linear) and rows <= 128
                and rows % 8 == 0 and head.scales.shape[0] * 128 == D
                and D <= 4096 and head.scales.shape[1] % 512 == 0)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """ln_f, then the head, f32 logits [B, T, V].

        bf16 head: an f32 result from the model-dtype weight (XLA's
        preferred_element_type=f32): on CUDA the bf16 tensor cores
        accumulate and write f32 (torch.bmm out_dtype), so no f32 copy of
        the 2 GB head is kept and logits are never rounded to bf16.
        Fused int4 head: `w4_qkv_norm` on ln_f's weight, bf16 logits cast
        to f32 (llada.py:684-699).  Other quantized heads: their linear with
        an f32 result."""
        B, T, D = x.shape
        head = self.ff_out
        if self.head_fusable(B * T):
            lg = w4_qkv_norm(x.reshape(B * T, D), self.ln_f.weight,
                             head.packed, head.scales, self.cfg.rms_norm_eps)
            return lg[:, :head.out_features].float().view(B, T, -1)
        x = self.ln_f(x)
        if isinstance(head, nn.Linear):
            return bmm_f32(x.reshape(1, B * T, D), head.weight.t()[None]) \
                .view(B, T, -1)
        return _run_linear(head, x, preferred=torch.float32)

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
        act_int8: bool = False,
        prefix_lengths: Optional[torch.Tensor] = None,
        attention_impl: str = "dense",
        remat=False,
    ):
        """Run the blocks on input embeddings [B, T, D].

        positions: [T] absolute RoPE positions (default: the row indices,
          offset by kv_write_index).
        kv_cache: per-layer preallocated (k, v) buffers [B, S, Hkv, hd], or
          int8 (k8, ks, v8, vs) buffers [B, Hkv, S, hd] / [B, Hkv, 1, S];
          requires kv_write_index (a host int), where this call's rows are
          written in place; keys at or past kv_write_index + T are masked.
        kv_valid: [B, S] bool over the buffer rows; self_valid: [B, T]
          bool over this call's rows.
        use_flash: attention through the short-attention kernel, masked by
          segment ids; otherwise dense attention with an additive bias.
        act_int8: per-token int8 activations on int8 linears, through the
          blocks' prefill tree when they have one (linear_act_int8).
        prefix_lengths: [B] the prefix-LM block mask for training
          (modeling_llada.py:1351-1368): key kv is visible from query q when
          kv < prefix_length or q >= prefix_length, over sequence indices.
        attention_impl: "dense", "prefix_flash" (self-attention only) or
          "auto" (prefix_flash on CUDA, dense on the CPU).
        remat: False or "whole_layer" / True (checkpoint each block while
          autograd records; no cache then).

        Returns (logits [B, T, V] f32, or ln_f(hidden) [B, T, D] when
        return_logits is False; the per-layer (k, v) list when use_cache,
        else None).
        """
        B, T, _ = embeds.shape
        device = embeds.device
        if attention_impl == "auto":
            attention_impl = ("prefix_flash" if device.type == "cuda"
                              else "dense")
        if attention_impl not in ("dense", "prefix_flash"):
            raise NotImplementedError(
                f"attention_impl {attention_impl!r}: the port has dense and "
                f"prefix_flash")
        remat = remat_layers(remat) and torch.is_grad_enabled()
        if remat and use_cache:
            raise ValueError("remat keeps no per-layer cache")
        if kv_cache is not None:
            if kv_write_index is None:
                raise NotImplementedError(
                    "kv_cache needs kv_write_index: only preallocated "
                    "buffers written in place are ported")
            kv8 = len(kv_cache[0]) == 4
            S = kv_cache[0][0].shape[2 if kv8 else 1]
            start = kv_write_index
        elif kv_write_index is not None or kv_valid is not None:
            raise ValueError("kv_write_index / kv_valid need a kv_cache")
        else:
            S, start, kv8 = T, 0, False
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
        bias = q_seg = kv_seg = pf_args = None
        if attention_impl == "prefix_flash":
            if kv_cache is not None or use_flash:
                raise ValueError("prefix_flash is the training self-attention:"
                                 " no kv_cache, no use_flash")
            plen = (prefix_lengths if prefix_lengths is not None else
                    torch.zeros(B, dtype=torch.int32, device=device))
            pf_args = (plen, valid)
        elif use_flash:
            if prefix_lengths is not None:
                raise ValueError("the flash path masks by segment ids; the "
                                 "prefix-LM mask needs prefix_flash or dense")
            if valid is not None:
                kv_seg = valid.to(torch.int32).contiguous()
                sv = (self_valid if self_valid is not None
                      else torch.ones(B, T, dtype=torch.bool, device=device))
                q_seg = sv.to(torch.int32).contiguous()
        elif (valid is not None or prefix_lengths is not None) and not kv8:
            # the prefix-LM mask is about SEQUENCE structure: sequence
            # indices, not the RoPE positions (llada.py:496-504)
            prefix = prefix_lengths is not None
            bias = make_bias(
                kv_valid=valid, prefix_lengths=prefix_lengths,
                q_positions=(torch.arange(start, start + T, device=device)
                             if prefix else None),
                kv_positions=torch.arange(S, device=device) if prefix else None)

        x = embeds
        presents = []
        for li, block in enumerate(self.blocks):
            kw = dict(sin=sin, cos=cos, positions=positions, bias=bias,
                      layer_past=None if kv_cache is None else kv_cache[li],
                      kv_write_index=kv_write_index, use_flash=use_flash,
                      q_seg=q_seg, kv_seg=kv_seg, act_int8=act_int8,
                      kv8_valid=valid if kv8 else None, prefix_flash=pf_args)
            if remat:
                x = checkpoint(lambda h, blk=block, kw=kw: blk(h, **kw)[0],
                               x, use_reentrant=False)
                continue
            x, present = block(x, **kw)
            if use_cache:
                presents.append(present)
        new_cache = presents if use_cache else None
        if not return_logits:
            return self.ln_f(x), new_cache
        return self.logits(x), new_cache

    # ------------------------------------------------------------------
    # serving layouts
    # ------------------------------------------------------------------

    @torch.no_grad()
    def to_fused_layout(self) -> LLaDAConfig:
        """llada.py:719-752 in place: each llama block becomes a sequential
        block with att_proj = [q|k|v] and ff_proj = [up|gate] (swiglu
        chunking gives silu(gate) * up), the old linears freed block by
        block.  Returns (and takes) the sequential config."""
        cfg = self.cfg
        if cfg.block_type != "llama":
            raise ValueError("to_fused_layout needs llama-layout blocks")
        new_cfg = cfg.replace(block_type="sequential", activation="swiglu",
                              mlp_hidden_size=2 * cfg.hidden_size)
        D = cfg.d_model
        for b in self.blocks:
            if not all(isinstance(getattr(b, n), nn.Linear)
                       for n in b.linear_names):
                raise ValueError("fuse before quantization")
            qkv = [b.q_proj.weight, b.k_proj.weight, b.v_proj.weight]
            upgate = [b.up_proj.weight, b.ff_proj.weight]
            del b.q_proj, b.k_proj, b.v_proj, b.up_proj, b.ff_proj
            for name, parts in (("att_proj", qkv), ("ff_proj", upgate)):
                w = torch.cat(parts)
                m = nn.Linear(D, w.shape[0], bias=False, device="meta")
                m.weight = nn.Parameter(w)
                setattr(b, name, m)
            del qkv, upgate, parts, w
            b.cfg = new_cfg
        self.cfg = new_cfg
        return new_cfg

    @torch.no_grad()
    def add_prefill_tree(self) -> None:
        """The mixed layout's int8 prefill tree (lavida.py:327-328): each
        block's linears quantized to int8 (`quantize_linear`) beside the
        ones it has, sharing its norms; `act_int8` forwards run them.  The
        head is left out: the prefill returns no logits."""
        for b in self.blocks:
            b.prefill = nn.ModuleDict({
                n: Int8Linear.from_linear(getattr(b, n))
                for n in b.linear_names})

    @torch.no_grad()
    def quantize(self, bits: int) -> None:
        """`quantize_params(consume=True)` (llada.py:807-866) in place:
        every linear of the blocks and the head becomes int8 (bits 8) or
        grouped int4 (bits 4; int8 where K breaks the 128-group), each bf16
        weight freed as soon as its quantized twin exists.  Norms and the
        embedding stay as they are."""
        for b in self.blocks:
            for n in b.linear_names:
                setattr(b, n, quantize_module(getattr(b, n), bits))
        self.ff_out = quantize_module(self.ff_out, bits)

    def adopt_layout(self, state: dict) -> None:
        """Swap each linear for the kind `state` holds (keys of a quantized
        state dict: `.weight_q` int8, `.packed` int4, `blocks.i.prefill.*`
        an int8 prefill tree), as meta modules for load_state_dict(assign=
        True); the true widths come from this model's config."""
        def kind(prefix, lin):
            if prefix + "packed" in state:
                return Int4Linear(lin.in_features, lin.out_features, "meta")
            if prefix + "weight_q" in state:
                return Int8Linear(lin.in_features, lin.out_features, "meta")
            return lin

        for i, b in enumerate(self.blocks):
            pre = f"blocks.{i}."
            for n in b.linear_names:
                setattr(b, n, kind(f"{pre}{n}.", getattr(b, n)))
            if any(k.startswith(pre + "prefill.") for k in state):
                b.prefill = nn.ModuleDict({
                    n: Int8Linear(getattr(b, n).in_features,
                                  getattr(b, n).out_features, "meta")
                    for n in b.linear_names})
        self.ff_out = kind("ff_out.", self.ff_out)
