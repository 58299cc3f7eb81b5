"""LLaDA: the bidirectional (non-causal) diffusion-LM transformer, ported
from lavida_mod_tpu/models/llada.py for the serving and training slices.

Covered: the "llama" block (separate q/k/v projections, SwiGLU as
silu(ff_proj) * up_proj, RMSNorm, RoPE) that LLaDA-8B uses, with Qwen2's
bias on q/k/v where `include_qkv_bias` is set (Dream-7B, models/dream.py),
and the fused "sequential" block `to_fused_layout` makes of it (att_proj =
[q|k|v] with the concatenated bias, ff_proj = [up|gate] chunked by the
swiglu activation, llada.py:111-124, 719-752), with the layers in a list
(the JAX package's unrolled inference layout, `unstack_blocks`), and the
forward paths the slices run:
  - a full forward over the input, optionally returning each layer's
    rotated K and V;
  - prefill with kv_write_index=0 into preallocated [B, P+G] buffers, the
    G unwritten rows masked by the filled-rows mask (llada.py:465-491),
    attention through the short-attention kernel with segment ids built
    from that mask (llada.py:537-548);
  - decode with kv_write_index=P (llada.py:296-329): over a bf16 cache on
    the card, not causal and without a prefix-LM mask, attention through
    the decode kernel, which reads the [B, S, Hkv, hd] buffers in place
    (ops/decode_attention.py, head dims 16 and 128); elsewhere (the CPU,
    other head dims, the AR baselines' causal decode) dense attention, as
    the JAX package's plain XLA;
  - the two other cache modes of llada.py:296-315, 449-504: with a
    kv_cache and neither index, "concat": the cache is a read-only past of
    S_past rows, this call's keys are appended (S = S_past + T) and the
    queries sit at S_past.. in the mask; with `kv_scatter_idx` [T],
    "scatter": this call's K/V are written in place at those cache rows,
    S is the buffer's size, the RoPE positions are the caller's and so is
    the whole mask (kv_valid, or none) -- the dLLM cache's partial
    recompute.  A quantized cache takes neither, as in the JAX package;
  - the f32 logits head (llada.py:700-708), and `head`, the head alone on
    normalized rows without the fused plan (the no-cache denoise's answer
    rows, the MC estimator's chunks).
The cache holds keys rotated once at write time, as in the JAX package.

Every option the JAX forward runs: the "default" / "low_precision"
LayerNorm and "gemma_rms" norms (`Norm`, norms.py:44-55), the sequential
block with the silu / gelu / relu activations (ff_out then takes the
whole hidden width), `rope=False`, `attention_layer_norm` (q_norm / k_norm
over the flattened projections, cast back to x's dtype, llada.py:
269-274), `input_emb_norm` (:479-480) and `scale_logits` (:709-710); the
fused W4 plans stay on the sequential/swiglu rms block.  `causal=True`
is the AR baselines' mask (llada.py:532-535, models/ar_models.py), and a
block may carry a mixture of experts in place of its FF linears
(models/moe.py, llada.py:350-356; no fused plan, no quantized layout).

Quantized serving (`quantize`, `add_prefill_tree`; llada.py:807-866): a
linear may be an `Int8Linear` or an `Int4Linear` (ops/quant.py).  With
`act_int8` the blocks run their int8 prefill tree, when one is attached,
through the W8A8 kernel, and the logits come from its int8 head.  A
block whose four linears are unpadded int4 in the sequential/swiglu
layout, with a bias on att_proj only, runs decode-sized rows (<= 32, a
multiple of 8) through the three fused W4A8 kernels (`fused_plan`,
llada.py:142-197; the bias in w4_qkv_norm's epilogue), and an int4 head
through `w4_qkv_norm` on ln_f, its logits rounded to bf16 and then cast
to f32 as in the JAX package (`head_fusable`, llada.py:200-216,
684-699).  Unlike the JAX package the plans engage on
the CPU too, where the ops run their plain versions.

With a quantized KV cache (a per-layer 4-tuple (k8, ks, v8, vs) in the
head-major layout of ops/kv8_attention.py, llada.py:285-295: int8 codes,
or int4 ones packed two a byte) each decode call quantizes its rows into
the buffers in place at their width (`write_rows`) and attends through
`kv8_decode_attention` (kernel #8) under the filled-rows and padding
mask.

Training (llada.py:407-667 on the list-of-layers model): `forward` takes
`prefix_lengths` [B], the prefix-LM block mask over SEQUENCE indices (never
the RoPE `positions`, which training may shift), and `attention_impl`:
"dense" builds make_bias's additive mask, "blockwise" runs the online
softmax over key blocks of `kv_block` (ops/attention.py, the masks built
per block), "prefix_flash" runs the fused prefix-LM kernel #10
(ops/prefix_flash.py, plen 0 when none is given) and "auto" picks
prefix_flash on CUDA and dense on the CPU, as train.py's --attn-impl auto
picks by backend.  `remat` is the JAX package's activation-checkpointing
strategy (llada.py:365-404, 603-668), on torch.utils.checkpoint:
  - "whole_layer" (or True): each block checkpointed, the layer boundaries
    kept and the inside recomputed in the backward;
  - "nested": sqrt checkpointing, G groups (the first of 8, 4, 2, 1 with
    L % G == 0 and L // G >= G; 1 below 4 layers), each group checkpointed
    and each layer inside it too;
  - "dots" / "dots_nobatch": each block checkpointed with a selective
    policy that saves matmul outputs (jax.checkpoint_policies'
    dots_saveable / dots_with_no_batch_dims_saveable): every aten
    mm / addmm / bmm / baddbmm output, or only the products without batch
    dims (mm / addmm: the linears; the attention's bmm products are
    recomputed); inside #10's autograd.Function the products are the
    kernel's and nothing is saved;
  - "one_in_N" or an int N: per group of N layers the first checkpointed
    and the other N - 1 plain (L % N must be 0); N = 1 is whole_layer.
The vision tower takes a bool (per-layer remat), as JAX's siglip.forward.

Weight tying (`weight_tying`, the 457m / 913m geometries): the model has
no `ff_out` and the head is wte's transpose (`head_weight`), in the
forward, `head`, the loss's ce_chunk and the quantized layouts, which keep
it in bf16 as the JAX package keeps its einsum with wte.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import LLaDAConfig, as_port_config

from ..ops.activations import gelu_erf, silu
from ..ops.attention import (NEG_INF, blockwise_attention, bmm_f32,
                             dense_attention, flash_attention, make_bias)
from ..ops.decode_attention import DEC_HEAD_DIMS, decode_attention
from ..ops.kv8_attention import kv8_decode_attention, write_rows
from ..ops.norms import NORM_TYPES, apply_norm
from ..ops.prefix_flash import prefix_flash_attention
from ..ops.quant import (Int4Linear, Int8Linear, has_lora, lora_term,
                         quantize_module)
from ..ops.rope import apply_rope, rope_tables
from ..ops.w4_fused import w4_ffn_fused, w4_matmul_res, w4_qkv_norm
from ..parallel.sharding import (ParallelLinear, embedding, is_dtensor,
                                 vocab_logits)
from .moe import TOP_K, MoE

_LINEARS = {"llama": ("q_proj", "k_proj", "v_proj", "attn_out", "ff_proj",
                      "up_proj", "ff_out"),
            "sequential": ("att_proj", "attn_out", "ff_proj", "ff_out")}
_FF_LINEARS = ("ff_proj", "up_proj", "ff_out")
_ACTIVATIONS = ("silu", "gelu", "relu", "swiglu")


def check_supported(cfg: LLaDAConfig) -> None:
    """Raise NotImplementedError for a config the JAX forward cannot run
    either: another block type, activation or norm type (llada.py:112-125,
    norms.py:44-55), or swiglu on the llama block, whose halved ff_proj
    cannot multiply up_proj."""
    unsupported = {
        "block_type": cfg.block_type not in _LINEARS,
        "activation": cfg.activation not in _ACTIVATIONS or (
            cfg.block_type == "llama" and cfg.activation == "swiglu"),
        "layer_norm_type": cfg.layer_norm_type not in NORM_TYPES,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"LLaDA runs the llama and sequential blocks with the silu, "
            f"gelu, relu (and, sequential only, swiglu) activations and the "
            f"{NORM_TYPES} norms; unsupported: {bad}")


def activation(cfg: LLaDAConfig, x: torch.Tensor) -> torch.Tensor:
    """`_act` (llada.py:112-125) in jax.nn's op order; swiglu chunks (x,
    gate) and returns silu(gate) * x."""
    a = cfg.activation
    if a == "silu":
        return silu(x)
    if a == "gelu":
        return gelu_erf(x)
    if a == "relu":
        return torch.relu(x)
    xx, gate = x.chunk(2, dim=-1)
    return silu(gate) * xx


def remat_plan(remat) -> tuple[str, int]:
    """An activation-checkpointing strategy (`_remat_group`, llada.py:
    368-394) as (kind, N): ("none", 1) for False / None / "none" / 0,
    ("whole_layer", 1) for True / "whole_layer" / one_in_1,
    ("nested" | "dots" | "dots_nobatch", 1), ("one_in", N) for "one_in_N"
    or an int N > 1; anything else raises ValueError."""
    if remat is None or remat is False or remat == "none" or (
            type(remat) is int and remat == 0):
        return "none", 1
    if remat is True or remat == "whole_layer":
        return "whole_layer", 1
    if remat in ("nested",) + _POLICIES:
        return remat, 1
    n = None
    if isinstance(remat, str) and remat.startswith("one_in_"):
        tail = remat[len("one_in_"):]
        n = int(tail) if tail.isdigit() else None
    elif type(remat) is int and remat > 0:
        n = remat
    if n is None:
        raise ValueError(f"unknown activation-checkpointing strategy: "
                         f"{remat!r}")
    return ("whole_layer", 1) if n == 1 else ("one_in", n)


# the aten products a selective-checkpoint policy saves (dots_saveable and
# dots_with_no_batch_dims_saveable): F.linear reaches mm / addmm, the
# attention's batched products bmm / baddbmm
_NOBATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_POLICIES = ("dots", "dots_nobatch")
_SAVED = {"dots_nobatch": _NOBATCH_DOTS,
          "dots": _NOBATCH_DOTS + (torch.ops.aten.bmm.default,
                                   torch.ops.aten.baddbmm.default)}


def _save_dots(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _policy_context(kind: str):
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_save_dots, _SAVED[kind]))


def nested_groups(n_layers: int) -> int:
    """The group count G of "nested" (llada.py:620-622)."""
    if n_layers < 4:
        return 1
    return next(g for g in (8, 4, 2, 1)
                if n_layers % g == 0 and n_layers // g >= g)


def run_blocks(blocks, x: torch.Tensor, layer, remat) -> torch.Tensor:
    """x through `blocks` by `layer(block, x)`, checkpointed by the
    strategy `remat` (see remat_plan)."""
    kind, n = remat_plan(remat)
    ckpt = functools.partial(checkpoint, use_reentrant=False)
    if kind == "none":
        for blk in blocks:
            x = layer(blk, x)
        return x
    if kind in _POLICIES:
        ctx = _policy_context(kind)
        for blk in blocks:
            x = ckpt(layer, blk, x, context_fn=ctx)
        return x
    if kind == "whole_layer":
        for blk in blocks:
            x = ckpt(layer, blk, x)
        return x
    L = len(blocks)
    if kind == "nested":
        G = nested_groups(L)

        def group(h, members):
            for blk in members:
                h = ckpt(layer, blk, h)
            return h

        for g in range(G):
            x = ckpt(group, x, blocks[g * (L // G):(g + 1) * (L // G)])
        return x
    if L % n:
        raise ValueError(f"activation_checkpointing one_in_{n} needs "
                         f"n_layers ({L}) divisible by {n}")
    for g in range(0, L, n):
        x = ckpt(layer, blocks[g], x)
        for blk in blocks[g + 1:g + n]:
            x = layer(blk, x)
    return x


def _block_n(*ns: int) -> Optional[int]:
    """llada.py:137-139: the largest of 512/256/128 dividing every n."""
    return next((b for b in (512, 256, 128)
                 if all(n % b == 0 for n in ns)), None)


def _run_linear(m: nn.Module, x: torch.Tensor, act_int8: bool = False,
                preferred=None) -> torch.Tensor:
    """`linear` / `linear_act_int8` (quant.py:170-230) on any linear kind.
    A float linear's LoRA term and bias are added to the rounded product,
    in its dtype (quant.py:182-186), never fused into the product's
    accumulation.  A sharded linear runs its parallel form
    (parallel/sharding.py)."""
    if isinstance(m, ParallelLinear):
        return m.linear(x)
    if isinstance(m, nn.Linear):
        y = lora_term(m, x, torch.nn.functional.linear(x, m.weight))
        return y if m.bias is None else y + m.bias
    return m(x, act_int8=act_int8, preferred=preferred)


class Norm(nn.Module):
    """The LM's norm of `cfg.layer_norm_type` (`apply_norm`, norms.py:
    44-55), weight only."""

    def __init__(self, dim: int, cfg: LLaDAConfig, device, dtype=None):
        super().__init__()
        self.kind = cfg.layer_norm_type
        self.rms_eps, self.ln_eps = cfg.rms_norm_eps, cfg.layer_norm_eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.weight, self.kind, self.rms_eps,
                          self.ln_eps)


class LLaDABlock(nn.Module):
    """One block (llada.py:219-362) in the llama or the sequential layout.
    `prefill`, when set, is a ModuleDict of the int8 twins of the linears
    that `act_int8` forwards use (the mixed layout's prefill tree); the
    norms are shared with the decode linears.  With `attention_layer_norm`
    the block has `q_norm` [D] and `k_norm` [kvD] (llada.py:94-96).  `moe`
    (`set_moe`) replaces the FF linears by a mixture of experts."""

    def __init__(self, cfg: LLaDAConfig, device, dtype=None):
        super().__init__()
        D, H = cfg.d_model, cfg.hidden_size
        kvD = cfg.effective_n_kv_heads * cfg.head_dim
        lin = dict(bias=False, device=device, dtype=dtype)
        # Qwen2's attention bias on q/k/v (llada.py:76-90), concatenated on
        # att_proj in the fused layout
        qkv = dict(lin, bias=cfg.include_qkv_bias)
        self.cfg = cfg
        self.attn_norm = Norm(D, cfg, device, dtype)
        self.ff_norm = Norm(D, cfg, device, dtype)
        if cfg.attention_layer_norm:
            self.q_norm = Norm(D, cfg, device, dtype)
            self.k_norm = Norm(kvD, cfg, device, dtype)
        self.attn_out = nn.Linear(D, D, **lin)
        if cfg.block_type == "llama":
            self.q_proj = nn.Linear(D, D, **qkv)
            self.k_proj = nn.Linear(D, kvD, **qkv)
            self.v_proj = nn.Linear(D, kvD, **qkv)
            self.ff_proj = nn.Linear(D, H, **lin)
            self.up_proj = nn.Linear(D, H, **lin)
            self.ff_out = nn.Linear(H, D, **lin)
        else:
            self.att_proj = nn.Linear(D, D + 2 * kvD, **qkv)
            self.ff_proj = nn.Linear(D, H, **lin)         # [up | gate]
            ff_in = H // 2 if cfg.activation == "swiglu" else H
            self.ff_out = nn.Linear(ff_in, D, **lin)
        self.prefill: Optional[nn.ModuleDict] = None
        self.moe: Optional[MoE] = None

    def set_moe(self, n_experts: int, hidden: int, device=None,
                dtype=None) -> MoE:
        """Replace the FF linears by `n_experts` experts of width `hidden`
        (uninitialised; the JAX block's "moe" entry, llada.py:350-356)."""
        w = self.attn_out.weight
        for n in _FF_LINEARS:
            if hasattr(self, n):
                delattr(self, n)
        self.moe = MoE(self.cfg.d_model, hidden, n_experts,
                       device or w.device, dtype or w.dtype)
        return self.moe

    @property
    def linear_names(self) -> tuple[str, ...]:
        names = _LINEARS[self.cfg.block_type]
        if self.moe is not None:
            return tuple(n for n in names if n not in _FF_LINEARS)
        return names

    def _lin(self, name: str, x: torch.Tensor, act_int8: bool,
             prefill_tree: bool = False):
        if (act_int8 or prefill_tree) and self.prefill is not None:
            return self.prefill[name](x, act_int8=act_int8)
        return _run_linear(getattr(self, name), x, act_int8)

    def fused_plan(self, rows: int, act_int8: bool) -> bool:
        """`_w4_fused_plan` (llada.py:142-197) as a geometry gate: the
        sequential/swiglu layout, decode-sized rows, four unpadded int4
        linears whose widths the TPU kernels' blocks divide, a bias on
        att_proj only (w4_qkv_norm adds it in its epilogue), no LoRA
        factors (llada.py:177: the kernels would drop them)."""
        cfg = self.cfg
        if act_int8 or self.moe is not None or not (
                cfg.block_type == "sequential" and cfg.activation == "swiglu"
                and cfg.layer_norm_type == "rms"):
            return False
        if rows > 32 or rows % 8:
            return False
        lins = [getattr(self, n) for n in self.linear_names]
        if not all(isinstance(m, Int4Linear) and not m.padded
                   and not has_lora(m) for m in lins):
            return False
        if any(m.bias is not None for m in lins if m is not self.att_proj):
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
                cache_mask=None, prefix_flash=None, kv_scatter_idx=None,
                prefill_tree=False, blockwise=None):
        """x [B, T, D] -> (x, (k, v)).  With `layer_past` (preallocated
        [B, S, Hkv, hd] buffers) this call's rotated k and v are written
        IN PLACE at rows [kv_write_index, kv_write_index + T), or at the
        rows `kv_scatter_idx` [T] -- the JAX package's dynamic_update_slice
        and scatter, without their functional copies -- and attention
        reads the whole buffers; with neither, `layer_past` is a read-only
        past that this call's k and v are appended to, and the present is
        this call's (k, v) alone (llada.py:296-315).  A 4-tuple
        `layer_past` is the int8 or int4 cache: the rows are quantized into
        it and attention runs the kv8 kernel masked by `cache_mask` [B, S];
        the present is the 4-tuple.  A bf16 cache with `cache_mask` (the
        write-index decode on the card) attends through the decode kernel
        under that mask.  prefill_tree: the linears of the
        int8 prefill tree where the block has one, with int8 activations
        only under act_int8 (weight-only otherwise)."""
        cfg = self.cfg
        B, T, D = x.shape
        Hkv, hd = cfg.effective_n_kv_heads, cfg.head_dim
        eps = cfg.rms_norm_eps
        fused = self.fused_plan(B * T, act_int8 or prefill_tree)

        def lin(name, h):
            return self._lin(name, h, act_int8, prefill_tree)

        if fused:
            qkv = w4_qkv_norm(x.reshape(B * T, D), self.attn_norm.weight,
                              self.att_proj.packed, self.att_proj.scales,
                              eps, self.att_proj.bias).view(B, T, -1)
            q, k, v = qkv.split([D, Hkv * hd, Hkv * hd], dim=-1)
        elif cfg.block_type == "llama":
            h = self.attn_norm(x)
            q, k, v = (lin(n, h) for n in ("q_proj", "k_proj", "v_proj"))
        else:
            qkv = lin("att_proj", self.attn_norm(x))
            q, k, v = qkv.split([D, Hkv * hd, Hkv * hd], dim=-1)
        if cfg.attention_layer_norm:
            # over the flattened projections, cast back to x's dtype
            # (llada.py:269-274)
            q = self.q_norm(q).to(x.dtype)
            k = self.k_norm(k).to(x.dtype)
        # -1 heads: a tensor-parallel rank holds its own heads
        q, k = q.reshape(B, T, -1, hd), k.reshape(B, T, -1, hd)
        if cfg.rope:
            q = apply_rope(q, positions, sin, cos, cfg.rope_full_precision)
            k = apply_rope(k, positions, sin, cos, cfg.rope_full_precision)
        v = v.reshape(B, T, -1, hd)
        if layer_past is not None and len(layer_past) == 4:
            if kv_write_index is None or use_flash:
                raise ValueError("the quantized KV cache is a decode cache:"
                                 " it needs kv_write_index and no flash")
            present = write_rows(*layer_past, k, v, kv_write_index)
            att = kv8_decode_attention(q, *present, kv_valid=cache_mask)
        else:
            present = (k, v)
            if layer_past is not None:
                pk, pv = layer_past
                if kv_scatter_idx is not None:
                    pk.index_copy_(1, kv_scatter_idx, k.to(pk.dtype))
                    pv.index_copy_(1, kv_scatter_idx, v.to(pv.dtype))
                    k, v = present = pk, pv
                elif kv_write_index is not None:
                    pk[:, kv_write_index:kv_write_index + T].copy_(k)
                    pv[:, kv_write_index:kv_write_index + T].copy_(v)
                    k, v = present = pk, pv
                else:       # a read-only past: this call's rows appended
                    k, v = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)
            if prefix_flash is not None:
                att = prefix_flash_attention(q, k, v, *prefix_flash)
            elif blockwise is not None:
                att = blockwise_attention(q, k, v, **blockwise)
            elif use_flash:
                # the kernel takes contiguous rows; v is a view of the
                # fused [q|k|v] projection in the sequential layout
                att = flash_attention(q, k, v.contiguous(), q_seg, kv_seg)
            elif cache_mask is not None:
                att = decode_attention(q, k, v, cache_mask)
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
        x = x + lin("attn_out", att.reshape(B, T, -1))
        h2 = self.ff_norm(x)
        if self.moe is not None:
            return x + self.moe(h2, TOP_K)[0], present
        # jax.nn's op order (ops/activations.py): in bf16 it rounds where
        # PyTorch's fused F.silu does not
        ff = activation(cfg, lin("ff_proj", h2))
        if cfg.block_type == "llama":
            ff = ff * lin("up_proj", h2)
        x = x + lin("ff_out", ff)
        return x, present


class LLaDA(nn.Module):
    """Embedding, blocks, final norm and the logits head (wte's transpose
    when the config ties them).  `moe` = (n_experts, hidden) gives every
    block a mixture of experts in place of its FF linears (the Mixtral
    layout, models/ar_models.py)."""

    def __init__(self, cfg: LLaDAConfig, device, dtype=None,
                 moe: Optional[tuple[int, int]] = None):
        super().__init__()
        cfg = as_port_config(cfg)
        check_supported(cfg)
        self.cfg = cfg
        D, E = cfg.d_model, cfg.num_embeddings
        self.wte = nn.Embedding(E, D, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            LLaDABlock(cfg, device, dtype) for _ in range(cfg.n_layers))
        if moe is not None:
            for b in self.blocks:
                b.set_moe(*moe, device=device, dtype=dtype)
        self.ln_f = Norm(D, cfg, device, dtype)
        self.ff_out: Optional[nn.Module] = None if cfg.weight_tying else \
            nn.Linear(D, E, bias=False, device=device, dtype=dtype)
        # the mixed layout's int8 head, the prefill tree's (add_prefill_tree)
        self.prefill_head: Optional[nn.Module] = None
        self._rope_key = None
        self._rope = None

    @property
    def head_weight(self) -> torch.Tensor:
        """The float head's [E, D] weight: ff_out's, or wte's when tied."""
        return self.wte.weight if self.ff_out is None else self.ff_out.weight

    @property
    def kv_heads(self) -> int:
        """The KV heads of this rank's cache: the config's, or its share
        under tensor parallelism (parallel.shard_params)."""
        return getattr(self, "_kv_heads", None) or \
            self.cfg.effective_n_kv_heads

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """wte lookup (modeling_llada.py:1283); vocab-parallel when wte is
        sharded."""
        if is_dtensor(self.wte.weight):
            return embedding(ids, self.wte.weight)
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
        """`_w4_head_fusable` (llada.py:200-216): an int4 head without a
        bias or LoRA factors over d_model <= 4096 and decode-sized rows."""
        head, D = self.ff_out, self.cfg.d_model
        return (isinstance(head, Int4Linear) and head.bias is None
                and self.cfg.layer_norm_type == "rms"
                and not has_lora(head)
                and rows <= 128
                and rows % 8 == 0 and head.scales.shape[0] * 128 == D
                and D <= 4096 and head.scales.shape[1] % 512 == 0)

    def head(self, x: torch.Tensor, prefill_tree: bool = False
             ) -> torch.Tensor:
        """The head alone on ln_f-normalized rows x [..., D] -> f32 logits
        [..., V], as `linear(x, ff_out, preferred=f32)` (quant.py:170-186)
        computes it, never the fused int4 head: bf16 weights through an
        f32-result product, quantized ones through their linear
        (weight-only int8, or the grouped int4 kernel), with prefill_tree
        the mixed layout's int8 head.  Row for row the value does not
        depend on how many rows come along."""
        head = self.ff_out
        if prefill_tree and self.prefill_head is not None:
            head = self.prefill_head
        if head is None or isinstance(head, nn.Linear):
            w = self.wte.weight if head is None else head.weight
            lead, D = x.shape[:-1], x.shape[-1]
            y = vocab_logits(lambda wl: bmm_f32(
                x.reshape(1, -1, D), wl.t()[None]).view(*lead, -1), w)
            return y if head is None else lora_term(head, x, y)
        return _run_linear(head, x, preferred=torch.float32)

    def logits(self, x: torch.Tensor, act_int8: bool = False,
               rows: Optional[int] = None) -> torch.Tensor:
        """ln_f, then the head, f32 logits [B, T, V].  With `act_int8` and
        the mixed layout's prefill head, that int8 head (weight-only, the
        JAX prefill tree's `linear(.., preferred=f32)`, llada.py:707-708).

        bf16 head: an f32 result from the model-dtype weight (XLA's
        preferred_element_type=f32): on CUDA the bf16 tensor cores
        accumulate and write f32 (torch.bmm out_dtype), so no f32 copy of
        the 2 GB head is kept and logits are never rounded to bf16.
        Fused int4 head: `w4_qkv_norm` on ln_f's weight, bf16 logits cast
        to f32 (llada.py:684-699), where `head_fusable` allows `rows` (the
        forward's row count when x is a slice of it; default x's).  Other
        quantized heads: their linear with an f32 result."""
        B, T, D = x.shape
        head = self.ff_out
        if act_int8 and self.prefill_head is not None:
            return self.head(self.ln_f(x), prefill_tree=True)
        if self.head_fusable(B * T if rows is None else rows):
            lg = w4_qkv_norm(x.reshape(B * T, D), self.ln_f.weight,
                             head.packed, head.scales, self.cfg.rms_norm_eps)
            return lg[:, :head.out_features].float().view(B, T, -1)
        return self.head(self.ln_f(x))

    def forward(
        self,
        embeds: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        kv_cache: Optional[list] = None,
        kv_valid: Optional[torch.Tensor] = None,
        self_valid: Optional[torch.Tensor] = None,
        kv_write_index: Optional[int] = None,
        kv_scatter_idx: Optional[torch.Tensor] = None,
        use_cache: bool = False,
        return_logits: bool = True,
        last_logits_only: bool = False,
        logits_from: int = 0,
        causal: bool = False,
        use_flash: bool = False,
        act_int8: bool = False,
        prefill_tree: bool = False,
        prefix_lengths: Optional[torch.Tensor] = None,
        attention_impl: str = "dense",
        kv_block: int = 1024,
        remat=False,
    ):
        """Run the blocks on input embeddings [B, T, D].

        positions: [T] absolute RoPE positions (default: the row indices,
          offset by kv_write_index, or by the past's length in the concat
          mode; required in the scatter mode).
        kv_cache: per-layer (k, v) buffers [B, S, Hkv, hd], or quantized
          (k8, ks, v8, vs) buffers [B, Hkv, S, hd] int8 or [B, Hkv, S,
          hd / 2] packed int4, and [B, Hkv, 1, S].  With kv_write_index (a
          host int) this call's rows are written in place there and keys
          at or past kv_write_index + T are masked; with kv_scatter_idx
          [T] (a long tensor of buffer rows) they are written in place at
          those rows and only kv_valid masks; with neither (bf16 only) the
          buffers are a read-only past of S_past rows and this call's keys
          are appended after them (S = S_past + T).
        kv_valid: [B, S] bool over the buffer rows (the past's rows in the
          concat mode); self_valid: [B, T] bool over this call's rows.
        last_logits_only: the logits of the last row only [B, 1, V]
          (modeling_llada.py:1426).
        logits_from: the logits of rows logits_from.. only (the head is
          row-wise: the values of the full forward's rows, the fused-head
          choice made on all of them, B * T or, with last_logits_only,
          B, as llada.py:679-684 makes it).
        causal: the causal mask of the AR baselines (llada.py:532-535):
          query row q sees key rows <= q, over the SEQUENCE indices of the
          mask (the buffer rows of this call; never the RoPE positions),
          added to the other masks; dense attention only (not with
          use_flash, blockwise or prefix_flash, as the JAX asserts).  A
          quantized cache's decode attends by its filled-rows mask alone,
          as the JAX kv8 branch does.
        use_flash: attention through the short-attention kernel, masked by
          segment ids; otherwise attention_impl's.
        act_int8: per-token int8 activations on int8 linears, through the
          blocks' prefill tree when they have one (linear_act_int8), and
          the prefill tree's int8 head.
        prefill_tree: the blocks' int8 prefill tree and head where they
          have one even without act_int8, weight-only (the JAX package's
          `prefill_params` passed as the weights, as the MC estimator of
          the mixed layout does).
        prefix_lengths: [B] the prefix-LM block mask for training
          (modeling_llada.py:1351-1368): key kv is visible from query q when
          kv < prefix_length or q >= prefix_length, over sequence indices.
        attention_impl: "dense", "blockwise" or "prefix_flash" (both
          self-attention only) or "auto" (prefix_flash on CUDA, dense on
          the CPU).
        kv_block: blockwise's key block.
        remat: an activation-checkpointing strategy (`remat_plan`; applied
          while autograd records; no cache then).

        Returns (logits [B, T, V] f32, or ln_f(hidden) [B, T, D] when
        return_logits is False; the per-layer (k, v) list when use_cache,
        else None).
        """
        B, T, _ = embeds.shape
        device = embeds.device
        if attention_impl == "auto":
            attention_impl = ("prefix_flash" if device.type == "cuda"
                              else "dense")
        if attention_impl not in ("dense", "blockwise", "prefix_flash"):
            raise ValueError(f"attention_impl {attention_impl!r}: dense, "
                             f"blockwise, prefix_flash or auto")
        if causal and (use_flash or attention_impl != "dense"):
            raise ValueError("the causal mask takes dense attention: no "
                             "use_flash, blockwise or prefix_flash")
        if not torch.is_grad_enabled() or remat_plan(remat)[0] == "none":
            remat = False
        if remat and use_cache:
            raise ValueError("remat keeps no per-layer cache")
        past = kv8 = 0
        if kv_cache is not None:
            kv8 = len(kv_cache[0]) == 4
            past = kv_cache[0][0].shape[2 if kv8 else 1]
            if kv8 and kv_write_index is None:
                raise ValueError("the quantized KV cache is a decode cache:"
                                 " it needs kv_write_index")
        elif (kv_write_index is not None or kv_valid is not None
              or kv_scatter_idx is not None):
            raise ValueError("kv_write_index / kv_scatter_idx / kv_valid "
                             "need a kv_cache")
        # a write-index call over a bf16 cache on the card (the decode
        # steps, and a prefill without the flash kernel) reads the buffers
        # in place through the decode kernel, at the head dims it is built
        # for; the causal AR decode, the prefix-LM mask, the flash prefill
        # and the CPU attend as before
        decode = (kv_write_index is not None and not kv8 and not use_flash
                  and not causal and prefix_lengths is None
                  and kv_cache[0][0].is_cuda
                  and kv_cache[0][0].dtype == torch.bfloat16
                  and self.cfg.head_dim in DEC_HEAD_DIMS)
        if kv_scatter_idx is not None:
            if positions is None:
                raise ValueError("scattered cache updates need explicit "
                                 "RoPE positions")
            S = past
        elif kv_write_index is not None:
            S, start = past, kv_write_index
        else:
            S, start = past + T, past
        if positions is None:
            positions = torch.arange(start, start + T, device=device)
        sin = cos = None
        if self.cfg.rope:
            sin, cos = self._rope_tables(
                max(self.cfg.max_sequence_length, S), device)

        valid = self_valid
        if kv_scatter_idx is not None:
            valid = kv_valid                # the caller owns the mask
        elif kv_write_index is not None:
            filled = torch.arange(S, device=device) < kv_write_index + T
            valid = filled[None].expand(B, S)
            if kv_valid is not None:
                valid = valid & kv_valid
            elif kv8 or decode:   # the kernels read the mask as bytes
                valid = valid.contiguous()
        elif past and (kv_valid is not None or self_valid is not None):
            pv = (kv_valid if kv_valid is not None else
                  torch.ones(B, past, dtype=torch.bool, device=device))
            sv = (self_valid if self_valid is not None else
                  torch.ones(B, T, dtype=torch.bool, device=device))
            valid = torch.cat([pv, sv], dim=1)
        bias = q_seg = kv_seg = pf_args = bw_args = None
        if attention_impl == "blockwise":
            if kv_cache is not None or use_flash:
                raise ValueError("blockwise is a training self-attention: no "
                                 "kv_cache, no use_flash")
            bw_args = dict(kv_valid=valid, prefix_lengths=prefix_lengths,
                           q_positions=torch.arange(start, start + T,
                                                    device=device),
                           kv_block=kv_block)
        elif attention_impl == "prefix_flash":
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
        elif (valid is not None or prefix_lengths is not None
              or causal) and not (kv8 or decode):
            # the prefix-LM and causal masks are about SEQUENCE structure:
            # sequence indices, not the RoPE positions (llada.py:496-504);
            # the mask's query rows in the buffer (llada.py:499-504)
            prefix = prefix_lengths is not None
            q_rows = (kv_scatter_idx if kv_scatter_idx is not None
                      else torch.arange(start, start + T, device=device))
            kv_rows = torch.arange(S, device=device)
            bias = make_bias(
                kv_valid=valid, prefix_lengths=prefix_lengths,
                q_positions=q_rows if prefix else None,
                kv_positions=kv_rows if prefix else None)
            if causal:
                cbias = torch.where(q_rows[:, None] >= kv_rows[None], 0.0,
                                    NEG_INF)[None, None]
                bias = cbias if bias is None else torch.clamp(
                    bias + cbias, min=NEG_INF)

        x = embeds
        if self.cfg.input_emb_norm:
            # llada.py:479-480: the constant in x's dtype, as JAX's weak
            # Python float becomes
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=device)
        presents = []
        kw = dict(sin=sin, cos=cos, positions=positions, bias=bias,
                  kv_write_index=kv_write_index, use_flash=use_flash,
                  q_seg=q_seg, kv_seg=kv_seg, act_int8=act_int8,
                  cache_mask=valid if kv8 or decode else None,
                  prefix_flash=pf_args,
                  kv_scatter_idx=kv_scatter_idx, prefill_tree=prefill_tree,
                  blockwise=bw_args)
        if remat:
            x = run_blocks(self.blocks, x,
                           lambda blk, h: blk(h, layer_past=None, **kw)[0],
                           remat)
        else:
            for li, block in enumerate(self.blocks):
                x, present = block(
                    x, layer_past=None if kv_cache is None else kv_cache[li],
                    **kw)
                if use_cache:
                    presents.append(present)
        new_cache = presents if use_cache else None
        if not return_logits:
            return self.ln_f(x), new_cache
        if last_logits_only:
            x = x[:, -1:]
        logits = self.logits(x[:, logits_from:], act_int8 or prefill_tree,
                             rows=x.shape[0] * x.shape[1])
        if self.cfg.scale_logits:           # llada.py:709-710
            logits = logits * (1.0 / math.sqrt(self.cfg.d_model))
        return logits, new_cache

    # ------------------------------------------------------------------
    # serving layouts
    # ------------------------------------------------------------------

    @torch.no_grad()
    def to_fused_layout(self) -> LLaDAConfig:
        """llada.py:719-752 in place: each llama block becomes a sequential
        block with att_proj = [q|k|v] and ff_proj = [up|gate] (swiglu
        chunking gives silu(gate) * up), the old linears freed block by
        block; q_norm / k_norm and a block's experts stay as they are (a
        block with `moe` fuses q|k|v only).  Returns (and takes) the
        sequential config."""
        cfg = self.cfg
        if cfg.block_type != "llama" or cfg.activation != "silu":
            raise ValueError("to_fused_layout needs llama-layout silu "
                             "blocks (swiglu chunking is silu(gate) * up)")
        new_cfg = cfg.replace(block_type="sequential", activation="swiglu",
                              mlp_hidden_size=2 * cfg.hidden_size)
        D = cfg.d_model
        for b in self.blocks:
            if not all(isinstance(getattr(b, n), nn.Linear)
                       for n in b.linear_names):
                raise ValueError("fuse before quantization")
            qkv = [b.q_proj.weight, b.k_proj.weight, b.v_proj.weight]
            upgate = (None if b.moe is not None
                      else [b.up_proj.weight, b.ff_proj.weight])
            qkv_bias = (None if b.q_proj.bias is None else torch.cat(
                [b.q_proj.bias, b.k_proj.bias, b.v_proj.bias]))
            del b.q_proj, b.k_proj, b.v_proj
            if upgate is not None:
                del b.up_proj, b.ff_proj
            for name, parts, bias in (("att_proj", qkv, qkv_bias),
                                      ("ff_proj", upgate, None)):
                if parts is None:
                    continue
                w = torch.cat(parts)
                m = nn.Linear(D, w.shape[0], bias=False, device="meta")
                m.weight = nn.Parameter(w)
                if bias is not None:      # llada.py:739-742
                    m.bias = nn.Parameter(bias)
                setattr(b, name, m)
            del qkv, upgate, parts, w, qkv_bias, bias
            b.cfg = new_cfg
        self.cfg = new_cfg
        return new_cfg

    @torch.no_grad()
    def add_prefill_tree(self) -> None:
        """The mixed layout's int8 prefill tree (lavida.py:327-328): each
        block's linears and the head quantized to int8 (`quantize_linear`,
        biases kept) beside the ones it has, sharing the norms, ln_f and
        the embedding; `act_int8` forwards run them (the head gives the
        Dream sampler its first token from the prefill)."""
        for b in self.blocks:
            b.prefill = nn.ModuleDict({
                n: Int8Linear.from_linear(getattr(b, n))
                for n in b.linear_names})
        if self.ff_out is not None:     # a tied head stays wte's, in bf16
            self.prefill_head = Int8Linear.from_linear(self.ff_out)

    @torch.no_grad()
    def quantize(self, bits: int) -> None:
        """`quantize_params(consume=True)` (llada.py:807-866) in place:
        every linear of the blocks and the head becomes int8 (bits 8) or
        grouped int4 (bits 4; int8 where K breaks the 128-group), each bf16
        weight freed as soon as its quantized twin exists.  Norms and the
        embedding stay as they are.  A block with experts has no quantized
        layout (the JAX moe_ff reads float kernels) and raises."""
        if any(b.moe is not None for b in self.blocks):
            raise ValueError("the MoE block has no quantized layout: serve "
                             "it in bf16")
        for b in self.blocks:
            for n in b.linear_names:
                setattr(b, n, quantize_module(getattr(b, n), bits))
        if self.ff_out is not None:     # a tied head stays wte's, in bf16
            self.ff_out = quantize_module(self.ff_out, bits)

    def adopt_layout(self, state: dict) -> None:
        """Swap each linear for the kind `state` holds (keys of a quantized
        state dict: `.weight_q` int8, `.packed` int4, `blocks.i.prefill.*`
        an int8 prefill tree; `blocks.i.moe.*` experts in place of the FF
        linears), as meta modules for load_state_dict(assign=True); the
        true widths come from this model's config (the experts' from their
        shapes)."""
        def kind(prefix, lin, cls=None):
            cls = cls or (Int4Linear if prefix + "packed" in state else
                          Int8Linear if prefix + "weight_q" in state else
                          None)
            if cls is None:
                return lin
            return cls(lin.in_features, lin.out_features, "meta",
                       bias=prefix + "bias" in state)

        for i, b in enumerate(self.blocks):
            pre = f"blocks.{i}."
            router = state.get(pre + "moe.router")
            if router is not None and b.moe is None:
                b.set_moe(router.shape[1], state[pre + "moe.ff_proj"].shape[2],
                          device="meta")
            if any(k.startswith(pre + "prefill.") for k in state):
                b.prefill = nn.ModuleDict({
                    n: kind(f"{pre}prefill.{n}.", getattr(b, n), Int8Linear)
                    for n in b.linear_names})
            for n in b.linear_names:
                setattr(b, n, kind(f"{pre}{n}.", getattr(b, n)))
        if self.ff_out is None:
            return
        if "prefill_head.weight_q" in state:
            self.prefill_head = kind("prefill_head.", self.ff_out, Int8Linear)
        self.ff_out = kind("ff_out.", self.ff_out)
