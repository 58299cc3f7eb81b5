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
  - The JAX scan becomes a Python loop over the control table.  The table
    and the block ends stay device tensors: the loop reads no value back
    to the host, so prefill + denoise can later be captured as one CUDA
    graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lavida_mod_tpu.config import GenerationConfig

from ..models.llada import LLaDA
from ..ops import sampling
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
    P = cache[0][0].shape[1] - G
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
) -> torch.Tensor:
    """Prefill the prefix [B, P, D] into preallocated [B, P+G] K/V buffers
    through the short-attention kernel (the JAX path with
    use_flash_prefill=True), then denoise x [B, G].  prefix_valid [B, P]
    bool masks front padding rows.  act_int8_prefill: the prefill runs
    the int8 prefill tree (A8 activations).  Returns the final [B, G]
    tokens."""
    cfg = model.cfg
    B, P, _ = prefix_embeds.shape
    G = x.shape[1]
    shape = (B, P + G, cfg.effective_n_kv_heads, cfg.head_dim)
    cache = [(prefix_embeds.new_zeros(shape), prefix_embeds.new_zeros(shape))
             for _ in model.blocks]
    kvv = None
    if prefix_valid is not None:
        kvv = torch.cat([prefix_valid, torch.ones(
            B, G, dtype=torch.bool, device=x.device)], dim=1)
    model(prefix_embeds, kv_cache=cache, kv_write_index=0, kv_valid=kvv,
          self_valid=prefix_valid, use_cache=True, return_logits=False,
          use_flash=True, act_int8=act_int8_prefill)
    return denoise_cached(model, x, cache, k_table, block_end, prefix_valid,
                          generator, temperature, remasking)
