"""Masked-diffusion generation, ported from
lavida_mod_tpu/generation/diffusion.py.

  - `build_control_table` is a numpy copy of the JAX host planner (that
    module imports jax): the per-step transfer counts depend only on each
    block's initial mask layout (drafts included), so the whole
    [steps, B] table is built before the loop.
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
  - `prefill` + `denoise_readonly`: the unpadded prefix cache
    (diffusion.py:46) and the read-only cached step over it
    (diffusion.py:297-312, the concat mode of `LLaDA.forward`), the route
    of the verbose history.
  - `denoise_full`: no cache (diffusion.py:536); every step runs the whole
    forward over [prefix, x]; the head runs on the answer rows only.
  - `generate_dllm`: the dLLM-cache partial recompute (diffusion.py:583),
    B = 1, its prefix prefilled by `prefill_cache` into [1, P+G] buffers
    (the JAX package's prefill and pad), then the scatter mode of
    `LLaDA.forward`.
  - The write-index denoise steps over a bf16 cache attend through the
    decode kernel on the card (ops/decode_attention.py, the buffers read in
    place; the JAX package's `generate` attends there in plain XLA by
    default, its use_flash=False), densely on the CPU; the no-cache steps,
    the read-only cached step and the dLLM scatter step attend densely, an
    int8 or int4 cache through kernel #8; the prefills run the
    short-attention kernel.
  - `generate` routes as the JAX `generate` (diffusion.py:682-842): the
    prefix cache, dLLM, verbose (cached and no-cache), no cache, draft
    tokens, and the JAX package's refusals; `generate_chunked_prefill`
    (:406-529, the prealloc branch) prefills fixed-size batch chunks
    straight into one merged [B, P+G] buffer (the last chunk overlapping
    when B is not a multiple of the chunk) and denoises the merged batch.
    With `kv8` the bf16 buffers are quantized once at decode entry into
    (k8, ks, v8, vs) buffers (:224-237) and the bf16 ones are freed: int8
    for kv8=True, int4 (packed two a byte) for kv8=4, the JAX package's
    convention.
  - The JAX scan becomes a Python loop over the control table.  The table
    and the block ends stay device tensors: the non-verbose loops read no
    value back to the host, so prefill + denoise can later be captured as
    one CUDA graph.
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
from ..utils.profiling import span


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
    with span("lm.denoise"):
        for i in range(k_table.shape[0]):
            with span("lm.step", device=True):
                with span("lm.forward"):
                    logits, _ = model(
                        model.embed_tokens(x), positions=positions,
                        kv_cache=cache, kv_valid=kv_valid, kv_write_index=P,
                        use_cache=True)
                with span("lm.commit"):
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
    shape = (B, P + G, model.kv_heads, cfg.head_dim)
    with span("lm.prefill", device=True):
        cache = [(prefix_embeds.new_zeros(shape),
                  prefix_embeds.new_zeros(shape)) for _ in model.blocks]
        c = min(chunk or B, B)
        starts = list(range(0, B - c + 1, c))
        if starts[-1] + c < B:
            starts.append(B - c)
        for lo in starts:
            with span("lm.prefill.chunk"):
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
def prefill(model: LLaDA, prefix_embeds: torch.Tensor,
            prefix_valid: Optional[torch.Tensor] = None) -> list:
    """The prefix [B, P, D] encoded once into an unpadded cache
    (diffusion.py:46-63) through the short-attention kernel (the port's
    prefill convention, the JAX package's use_flash_prefill): the
    per-layer (k, v) [B, P, Hkv, hd] with rotated keys, read by the
    concat mode of `LLaDA.forward`."""
    with span("lm.prefill", device=True):
        _, cache = model(prefix_embeds, self_valid=prefix_valid,
                         use_cache=True, return_logits=False, use_flash=True)
    return cache


def denoise_readonly(
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
    """Denoise steps over a read-only prefix cache (diffusion.py:297-313):
    each step appends x's K/V to the unpadded cache (the concat mode),
    masked by prefix_valid over the prefix.  Returns the final x [B, G]."""
    B, G = x.shape
    P = cache[0][0].shape[1]
    positions = torch.arange(P, P + G, device=x.device)
    mask_id = model.cfg.mask_token_id
    with span("lm.denoise"):
        for i in range(k_table.shape[0]):
            with span("lm.step", device=True):
                with span("lm.forward"):
                    logits, _ = model(model.embed_tokens(x),
                                      positions=positions, kv_cache=cache,
                                      kv_valid=prefix_valid)
                with span("lm.commit"):
                    x = sampling.denoise_commit(
                        x, logits, x == mask_id, k_table[i], block_end[i],
                        temperature=temperature, remasking=remasking,
                        generator=generator)
    return x


def denoise_full(
    model: LLaDA,
    x: torch.Tensor,
    prefix_embeds: torch.Tensor,
    k_table: torch.Tensor,
    block_end: torch.Tensor,
    prefix_valid: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    temperature: float,
    remasking: str,
) -> torch.Tensor:
    """The no-cache denoise (`_denoise_scan_full`, diffusion.py:536-575):
    every step re-embeds x, concatenates it after the prefix and runs the
    whole bidirectional forward over P + G rows (self_valid masking the
    prefix's padding).  The head runs on the G answer rows alone
    (`logits_from=P`), where JAX computes [B, P + G, V] logits and keeps
    [:, P:]: the head is row-wise and its kind (fused or not) is chosen on
    all P + G rows, so the kept rows are the same values, without the
    prefix's logits.  block_end [steps] is absolute (prefix included), as
    the no-cache control table builds it.  Returns x."""
    B, G = x.shape
    P = prefix_embeds.shape[1]
    mask_id = model.cfg.mask_token_id
    sv = None
    if prefix_valid is not None:
        sv = torch.cat([prefix_valid, torch.ones(
            B, G, dtype=torch.bool, device=x.device)], dim=1)
    with span("lm.denoise"):
        for i in range(k_table.shape[0]):
            with span("lm.step", device=True):
                with span("lm.forward"):
                    embeds = torch.cat(
                        [prefix_embeds,
                         model.embed_tokens(x).to(prefix_embeds.dtype)],
                        dim=1)
                    logits, _ = model(embeds, self_valid=sv, logits_from=P)
                with span("lm.commit"):
                    x = sampling.denoise_commit(
                        x, logits, x == mask_id, k_table[i], block_end[i] - P,
                        temperature=temperature, remasking=remasking,
                        generator=generator)
    return x


def dllm_rows(prio: torch.Tensor, r: int) -> torch.Tensor:
    """The r rows a dLLM step re-forwards: the r largest priorities in
    descending order, ties to the lower index first, as jax.lax.top_k
    orders them (torch.topk breaks ties in no promised order, and the
    priorities tie all the time).  prio [G] f32 -> [r] long."""
    return torch.sort(prio, descending=True, stable=True).indices[:r]


@torch.no_grad()
def generate_dllm(
    model: LLaDA,
    x: torch.Tensor,
    prefix_embeds: torch.Tensor,
    k_table: torch.Tensor,
    block_end: torch.Tensor,
    prefix_valid: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    recompute: int,
    temperature: float,
    remasking: str,
) -> torch.Tensor:
    """dLLM-Cache-style denoising at B = 1 (`_generate_dllm_fused`,
    diffusion.py:583-679): `dllm_init`, then each step (`dllm_step`)
    re-forwards only r = min(recompute, G) rows, chosen by
    prio = changed * 1e6 + where(masked, stale, -1e6) (the rows committed
    last step, then the stalest masked ones; `dllm_rows`), through the
    scatter mode, which writes their K/V in place at those rows; their
    logits replace the cached ones and the commit reads the whole logits
    cache.  `stale` counts the steps since a row was last re-forwarded.
    recompute >= G re-forwards every row each step: the cached scan.
    Returns x [1, G]."""
    if x.shape[0] != 1:
        raise ValueError("dLLM cache path is the B=1 serving latency path")
    r = min(recompute, x.shape[1])
    state, cache, kv_valid = dllm_init(model, x, prefix_embeds, prefix_valid)
    with span("lm.denoise"):
        for i in range(k_table.shape[0]):
            with span("lm.step", device=True):
                state = dllm_step(model, *state, cache, kv_valid, k_table[i],
                                  block_end[i], r, generator, temperature,
                                  remasking)
    return state[0]


def dllm_init(model: LLaDA, x: torch.Tensor, prefix_embeds: torch.Tensor,
              prefix_valid: Optional[torch.Tensor] = None):
    """The dLLM state before its first step (diffusion.py:614-648): the
    prefix prefilled into [1, P + G] buffers (`prefill_cache`), then one
    init pass over x's G rows at write index P that seeds their K/V and
    the bf16 logits cache.  Returns ((x, logits_c [1, G, V] bf16, changed
    [G] bool, stale [G] f32), cache, kv_valid)."""
    B, G = x.shape
    P = prefix_embeds.shape[1]
    device = x.device
    cache = prefill_cache(model, prefix_embeds, G, prefix_valid)
    kv_valid = None
    if prefix_valid is not None:
        kv_valid = torch.cat([prefix_valid, torch.ones(
            B, G, dtype=torch.bool, device=device)], dim=1)
    logits_c, _ = model(model.embed_tokens(x),
                        positions=torch.arange(P, P + G, device=device),
                        kv_cache=cache, kv_valid=kv_valid, kv_write_index=P,
                        use_cache=True)
    state = (x, logits_c.to(torch.bfloat16),
             torch.zeros(G, dtype=torch.bool, device=device),
             torch.zeros(G, dtype=torch.float32, device=device))
    return state, cache, kv_valid


def dllm_step(model: LLaDA, x, logits_c, changed, stale, cache, kv_valid,
              k_row, b_end, r: int, generator, temperature: float,
              remasking: str):
    """One step of `generate_dllm` (diffusion.py:649-671): x [1, G],
    logits_c [1, G, V] bf16, changed [G] bool (committed last step), stale
    [G] f32, the [1, P + G] cache; the cache and logits_c are written in
    place.  Returns the new (x, logits_c, changed, stale)."""
    G = x.shape[1]
    P = cache[0][0].shape[1] - G
    masked = x[0] == model.cfg.mask_token_id
    prio = (changed.to(torch.float32) * 1e6
            + torch.where(masked, stale, torch.full_like(stale, -1e6)))
    pos = dllm_rows(prio, r)
    with span("lm.forward"):
        logits_r, _ = model(model.embed_tokens(x[:, pos]), positions=P + pos,
                            kv_cache=cache, kv_valid=kv_valid,
                            kv_scatter_idx=P + pos, use_cache=True)
        logits_c[:, pos] = logits_r.to(logits_c.dtype)
    with span("lm.commit"):
        x_new = sampling.denoise_commit(
            x, logits_c.float(), x[0:1] == model.cfg.mask_token_id, k_row,
            b_end, temperature=temperature, remasking=remasking,
            generator=generator)
    fresh = torch.zeros(G, dtype=torch.bool, device=x.device)
    fresh[pos] = True
    stale = torch.where(fresh, torch.zeros_like(stale), stale + 1.0)
    return x_new, logits_c, (x_new != x)[0], stale


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
):
    """`gen.max_new_tokens` tokens after prefix_embeds [B, P, D] -> x
    [B, G] (diffusion.py:682-812), or (x, history) when verbose, history
    one numpy [B, G] snapshot of x after every step.

    draft_tokens [B, Td] (Td <= G): a FIM skeleton written into the head of
    x (generate.py:189-191); the control table is built from that x, so
    drafted positions are never counted as masked, and only the mask-id
    holes are denoised.  act_int8_prefill: the mixed layout's split (the
    int8 tree prefills, the decode linears denoise).  kv8: False, True
    (the int8 KV cache) or 4 (the int4 one).  chunk: the chunked prefill
    of `generate_chunked_prefill`.

    Routes, as the JAX package routes them:
      - gen.prefix_lm, the default: the prefill into [B, P + G] buffers and
        the write-index denoise (`generate_cached_fused`); dllm_cache=r:
        `generate_dllm`
        (B = 1); verbose: `prefill` + one `denoise_readonly` step at a time;
      - prefix_lm=False: no cache, `denoise_full`, its control table in
        absolute coordinates (a [B, P + G] buffer whose prefix is never
        masked); verbose: one step at a time.  kv8 has no cache to act on
        there and is unused, as in the JAX package.
    NotImplementedError, with the JAX package's messages, for kv8 or the
    mixed split with dLLM or verbose, verbose with dLLM, and the mixed
    split without the cache."""
    gen = as_port_config(gen)
    B, P, _ = prefix_embeds.shape
    G = gen.max_new_tokens
    mask_id = model.cfg.mask_token_id
    device = prefix_embeds.device
    x_host = np.full((B, G), mask_id, np.int64)
    if draft_tokens is not None:
        draft = np.asarray(draft_tokens.cpu() if torch.is_tensor(draft_tokens)
                           else draft_tokens)
        if draft.shape[1] > G:
            raise ValueError(f"{draft.shape[1]} draft tokens in a "
                             f"{G}-token buffer")
        x_host[:, :draft.shape[1]] = draft
    with span("lm.plan"):
        x = torch.as_tensor(x_host, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        # the no-cache table is in absolute coordinates: a [B, P + G]
        # buffer whose prefix is never masked
        x0, prompt_len = (x_host, 0) if gen.prefix_lm else (np.concatenate(
            [np.zeros((B, P), np.int64), x_host], axis=1), P)
        k_table, block_end = build_control_table(x0, prompt_len, G, gen,
                                                 mask_id)
        n = k_table.shape[0]
        k_table = torch.as_tensor(k_table, device=device)
        block_end = torch.as_tensor(block_end, device=device)

    sample = (generator, gen.temperature, gen.remasking)
    if gen.prefix_lm:
        if n == 0:
            return (x, []) if verbose else x
        if dllm_cache is not None:
            if kv8 or act_int8_prefill:
                raise NotImplementedError(
                    "kv8 / act_int8_prefill / mixed decode_params are not "
                    "implemented for the dLLM partial-recompute path; "
                    "drop --kv8/--mixed or --dllm")
            if verbose:
                raise NotImplementedError(
                    "verbose history is not implemented for the dLLM "
                    "partial-recompute path; drop --dllm or verbose")
            return generate_dllm(model, x, prefix_embeds, k_table, block_end,
                                 prefix_valid, generator, int(dllm_cache),
                                 gen.temperature, gen.remasking)
        if not verbose:
            return generate_cached_fused(
                model, x, prefix_embeds, k_table, block_end, prefix_valid,
                *sample, act_int8_prefill=act_int8_prefill, kv8=kv8,
                chunk=chunk)
        if kv8 or act_int8_prefill:
            raise NotImplementedError(
                "kv8 / act_int8_prefill / mixed decode_params are only "
                "wired on the fused non-verbose path; drop --kv8/--mixed "
                "or verbose")
        cache = prefill(model, prefix_embeds, prefix_valid)

        def step(x, i):
            return denoise_readonly(model, x, cache, k_table[i:i + 1],
                                    block_end[i:i + 1], prefix_valid,
                                    *sample)
    else:
        if act_int8_prefill:
            raise NotImplementedError(
                "mixed decode_params needs the prefix-cache mode "
                "(prefix_lm=True) — the no-cache path has no "
                "prefill/decode split")
        if n == 0:
            return (x, []) if verbose else x
        if not verbose:
            return denoise_full(model, x, prefix_embeds, k_table, block_end,
                                prefix_valid, *sample)

        def step(x, i):
            return denoise_full(model, x, prefix_embeds, k_table[i:i + 1],
                                block_end[i:i + 1], prefix_valid, *sample)
    history = []
    for i in range(n):              # `_generate_verbose` (diffusion.py:815)
        x = step(x, i)
        history.append(x.cpu().numpy())
    return x, history


def generate_chunked_prefill(model: LLaDA, prefix_embeds: torch.Tensor,
                             gen: GenerationConfig, *, chunk: int = 4,
                             **kw) -> torch.Tensor:
    """Large-batch serving (diffusion.py:406-529, prealloc branch): the
    prefix prefilled in `chunk`-row slices straight into one merged
    [B, P+G] buffer, then one denoise over the merged batch.  Keywords as
    `generate`'s.  Returns [B, G]."""
    return generate(model, prefix_embeds, gen, chunk=chunk, **kw)
