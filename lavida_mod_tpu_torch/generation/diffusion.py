"""Masked-diffusion generation with the prefix KV cache, ported from
lavida_mod_tpu/generation/diffusion.py for the serving slice.

  - `build_control_table` is a numpy copy of the JAX host planner (that
    module imports jax): the per-step transfer counts depend only on each
    block's initial mask layout, so the whole [steps, B] table is built
    before the loop.
  - `generate_cached_fused` is the prealloc branch of
    `_generate_cached_fused_body` (diffusion.py:139-168): the prefix is
    prefilled straight into preallocated [B, P+G] K/V buffers
    (kv_write_index=0) through the short-attention kernel, then
    `denoise_cached` runs the write-index decode of
    `_denoise_scan_cached_body` (diffusion.py:216-295), which writes each
    step's G rows of K/V in place at rows [P, P+G).  With
    `act_int8_prefill` (the mixed serving layout) the prefill runs the
    blocks' int8 prefill tree with per-token int8 activations and the
    denoise loop the decode linears -- `_generate_cached_fused_body`'s
    `params` / `decode_params` / `act_int8_prefill` (diffusion.py:111-168),
    with the two trees inside one module.
  - `generate` is the JAX `generate` (diffusion.py:682-766) in its
    prefix-cache, non-verbose, non-dLLM branch: the control table, then
    `generate_cached_fused`; `generate_chunked_prefill` (:406-529, the
    prealloc branch) prefills fixed-size batch chunks straight into one
    merged [B, P+G] buffer (the last chunk overlapping when B is not a
    multiple of the chunk) and denoises the merged batch.  With `kv8` the
    bf16 buffers are quantized once at decode entry into (k8, ks, v8, vs)
    buffers (:224-237) and the bf16 ones are freed: int8 for kv8=True, int4
    (packed two a byte) for kv8=4, the JAX package's convention.
  - The JAX scan becomes a Python loop over the control table.  The table
    and the block ends stay device tensors: the loop reads no value back
    to the host, so prefill + denoise can later be captured as one CUDA
    graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import GenerationConfig, as_port_config

from ..models.llada import LLaDA
from ..ops import sampling
from ..ops.kv8_attention import quantize_kv
from ..ops.schedules import num_transfer_tokens_scheduled, resolve_steps


def build_control_table(
    x0_host: np.ndarray,
    prompt_len: int,
    gen_length: int,
    gen: GenerationConfig,
    mask_id: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(k_table [total_steps, B] int32, block_end [total_steps] int32) for
    the initial token buffer x0_host [B, prompt_len + gen_length] (or
    [B, gen_length] when prompt_len == 0); block_end is absolute in x
    coordinates.  A fully drafted block contributes no steps."""
    x0_host = np.asarray(x0_host)
    B = x0_host.shape[0]
    num_blocks, steps = resolve_steps(
        gen_length, gen.block_length, gen.steps, gen.step_per_block,
        gen.step_ratio)
    k_cols: list[np.ndarray] = []
    end_cols: list[int] = []
    for b in range(num_blocks):
        lo = prompt_len + b * gen.block_length
        hi = prompt_len + (b + 1) * gen.block_length
        counts = (x0_host[:, lo:hi] == mask_id).sum(axis=1)
        if counts.max() == 0:
            continue
        table = num_transfer_tokens_scheduled(
            counts, steps, gen.schedule, shift=gen.schedule_shift)
        if table.shape[1] < steps:
            pad = np.zeros((B, steps - table.shape[1]), np.int64)
            table = np.concatenate([table, pad], axis=1)
        for i in range(steps):
            k_cols.append(table[:, i])
            end_cols.append(hi)
    if not k_cols:
        return np.zeros((0, B), np.int32), np.zeros((0,), np.int32)
    return np.stack(k_cols).astype(np.int32), np.asarray(end_cols, np.int32)


def denoise_cached(
    model: LLaDA,
    x: torch.Tensor,
    cache: list,
    k_table: torch.Tensor,
    block_end: torch.Tensor,
    prefix_valid: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    temperature: float,
    remasking: str,
) -> torch.Tensor:
    """The write-index denoise loop over preallocated [B, P+G] buffers.
    x [B, G] token buffer; k_table [steps, B]; block_end [steps], both on
    x's device.  Returns the final x."""
    B, G = x.shape
    P = cache[0][0].shape[2 if len(cache[0]) == 4 else 1] - G
    positions = torch.arange(P, P + G, device=x.device)
    kv_valid = None
    if prefix_valid is not None:
        kv_valid = torch.cat([prefix_valid, torch.ones(
            B, G, dtype=torch.bool, device=x.device)], dim=1)
    mask_id = model.cfg.mask_token_id
    for i in range(k_table.shape[0]):
        logits, _ = model(
            model.embed_tokens(x), positions=positions, kv_cache=cache,
            kv_valid=kv_valid, kv_write_index=P, use_cache=True)
        x = sampling.denoise_commit(
            x, logits, x == mask_id, k_table[i], block_end[i],
            temperature=temperature, remasking=remasking,
            generator=generator)
    return x


@torch.no_grad()
def generate_cached_fused(
    model: LLaDA,
    x: torch.Tensor,
    prefix_embeds: torch.Tensor,
    k_table: torch.Tensor,
    block_end: torch.Tensor,
    prefix_valid: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    temperature: float,
    remasking: str,
    act_int8_prefill: bool = False,
    kv8: bool | int = False,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Prefill the prefix [B, P, D] (`prefill_cache`), then denoise x
    [B, G] over the cache.  Returns the final [B, G] tokens."""
    cache = prefill_cache(model, prefix_embeds, x.shape[1], prefix_valid,
                          act_int8_prefill, kv8, chunk)
    return denoise_cached(model, x, cache, k_table, block_end, prefix_valid,
                          generator, temperature, remasking)


@torch.no_grad()
def prefill_cache(model: LLaDA, prefix_embeds: torch.Tensor, G: int,
                  prefix_valid: Optional[torch.Tensor] = None,
                  act_int8: bool = False, kv8: bool | int = False,
                  chunk: Optional[int] = None) -> list:
    """The prefix [B, P, D] prefilled into preallocated [B, P+G] K/V
    buffers through the short-attention kernel (the JAX path with
    use_flash_prefill=True); prefix_valid [B, P] bool masks front padding
    rows.  act_int8: the prefill runs the int8 prefill tree (A8
    activations).  kv8: the buffers quantized into the int8 cache (True) or
    the int4 one (4).  chunk:
    prefill in slices of this many rows, each written in place into the
    merged buffers, the last slice an overlapping window ending at B when
    chunk does not divide B (prefill is deterministic, so the rewritten
    rows are identical).  Returns the per-layer cache list."""
    B, P, _ = prefix_embeds.shape
    cfg = model.cfg
    shape = (B, P + G, cfg.effective_n_kv_heads, cfg.head_dim)
    cache = [(prefix_embeds.new_zeros(shape), prefix_embeds.new_zeros(shape))
             for _ in model.blocks]
    c = min(chunk or B, B)
    starts = list(range(0, B - c + 1, c))
    if starts[-1] + c < B:
        starts.append(B - c)
    for lo in starts:
        _prefill_into(model, cache, prefix_embeds[lo:lo + c],
                      None if prefix_valid is None
                      else prefix_valid[lo:lo + c], lo, act_int8)
    if not kv8:
        return cache
    return quantize_cache(cache, 4 if kv8 == 4 else 8)


def _prefill_into(model: LLaDA, cache: list, embeds: torch.Tensor,
                  valid: Optional[torch.Tensor], lo: int,
                  act_int8: bool) -> None:
    """Prefill embeds [C, P, D] into rows [lo, lo + C) of the [B, S]
    buffers, in place (kv_write_index=0; the S - P unwritten rows masked)."""
    C, P, _ = embeds.shape
    S = cache[0][0].shape[1]
    kvv = None
    if valid is not None:
        kvv = torch.cat([valid, torch.ones(C, S - P, dtype=torch.bool,
                                           device=valid.device)], dim=1)
    model(embeds, kv_cache=[(k[lo:lo + C], v[lo:lo + C]) for k, v in cache],
          kv_write_index=0, kv_valid=kvv, self_valid=valid, use_cache=True,
          return_logits=False, use_flash=True, act_int8=act_int8)


def quantize_cache(cache: list, bits: int = 8) -> list:
    """bf16 [B, S, Hkv, hd] (k, v) buffers -> (k8, ks, v8, vs) ones of
    `bits`-bit codes (diffusion.py:228-237), quantized once at decode entry
    (int4 with the reciprocal scale of JAX's jitted decode)."""
    return [(*quantize_kv(k, bits, reciprocal=bits == 4),
             *quantize_kv(v, bits, reciprocal=bits == 4)) for k, v in cache]


@torch.no_grad()
def generate(
    model: LLaDA,
    prefix_embeds: torch.Tensor,
    gen: GenerationConfig,
    *,
    prefix_valid: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    act_int8_prefill: bool = False,
    kv8: bool | int = False,
    chunk: Optional[int] = None,
    draft_tokens=None,
    verbose: bool = False,
    dllm_cache: Optional[int] = None,
) -> torch.Tensor:
    """`gen.max_new_tokens` tokens after prefix_embeds [B, P, D] ->
    [B, G] (diffusion.py:682-766, prefix_lm branch).  act_int8_prefill:
    the mixed layout's split (the int8 tree prefills, the decode linears
    denoise).  kv8: False, True (the int8 KV cache) or 4 (the int4 one).
    chunk: the chunked prefill of `generate_chunked_prefill`.
    Draft tokens, the verbose and dLLM-cache paths and prefix_lm=False
    raise NotImplementedError."""
    gen = as_port_config(gen)
    if not gen.prefix_lm or draft_tokens is not None or verbose \
            or dllm_cache is not None:
        raise NotImplementedError(
            "the port's generate implements the prefix-cache, non-verbose, "
            "non-dLLM path without draft tokens only")
    B, G = prefix_embeds.shape[0], gen.max_new_tokens
    mask_id = model.cfg.mask_token_id
    device = prefix_embeds.device
    x = torch.full((B, G), mask_id, dtype=torch.long, device=device)
    k_table, block_end = build_control_table(
        np.full((B, G), mask_id, np.int64), 0, G, gen, mask_id)
    if k_table.shape[0] == 0:
        return x
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generate_cached_fused(
        model, x, prefix_embeds, torch.as_tensor(k_table, device=device),
        torch.as_tensor(block_end, device=device), prefix_valid, generator,
        gen.temperature, gen.remasking, act_int8_prefill=act_int8_prefill,
        kv8=kv8, chunk=chunk)


def generate_chunked_prefill(model: LLaDA, prefix_embeds: torch.Tensor,
                             gen: GenerationConfig, *, chunk: int = 4,
                             **kw) -> torch.Tensor:
    """Large-batch serving (diffusion.py:406-529, prealloc branch): the
    prefix prefilled in `chunk`-row slices straight into one merged
    [B, P+G] buffer, then one denoise over the merged batch.  Keywords as
    `generate`'s.  Returns [B, G]."""
    return generate(model, prefix_embeds, gen, chunk=chunk, **kw)
