"""The Dream diffusion sampler, ported from
lavida_mod_tpu/generation/dream_sampler.py (reference
dream/generation_utils.py:298-527, `_sample`).

  - the prefix is prefilled into preallocated [B, P+G] K/V buffers
    (kv_write_index=0, the G unwritten rows masked), and the prefill's last
    logit gives the first generated token by its argmax
    (generation_utils.py:424-428); in the mixed layout the prefill runs the
    int8 prefill tree with per-token int8 activations and its int8 head;
  - every decode step writes its G rows of K/V in place at [P, P+G) and
    shifts its logits one position right, `cat(logits[:, :1],
    logits[:, :-1])` (:470-473): Dream keeps the AR-style head where
    position i-1 predicts token i;
  - the confidence algs: origin (per-token Bernoulli transfer),
    maskgit_plus (the sampled token's probability), topk_margin (top-1
    minus top-2 probability, by two max passes) and entropy (the negative
    entropy) (:478-505, sample_tokens :58-93);
  - the transfer counts come from `build_dream_schedule`, host-side: the
    shared schedule table or the vanilla `int(m * (1 - s / t))` cascade,
    which depends only on the initial mask count;
  - alg_temp samples the transfer set from softmax(conf / alg_temp)
    without replacement, as Gumbel top-k (:508-511).
The JAX scan becomes a Python loop; the tables are device tensors, so the
loop reads nothing back to the host.  `_dream_hooked` is the same loop
with the reference's hooks (`generation_tokens_hook_func`,
`generation_logits_hook_func`, generation_utils.py:308-309) and the
per-step history of `verbose`; both share `_commit_step`, so they are
token-identical under identity hooks.

Randomness (temperature > 0, origin's transfer draws, alg_temp) comes from
an explicit `torch.Generator` (default: seed 0 on the prefix's device); it
does not reproduce jax.random's bits, so parity with the JAX package is
token-exact only without it.  `_commit_step` and `sample_tokens` take the
draws injected (`noise`, `gumbel_noise`), which is how the tests hold them
to the JAX functions fed the same draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DreamGenerationConfig, as_port_config
from ..models.llada import LLaDA
from ..ops.sampling import NEG_INF, _uniform, topk_transfer_mask
from ..ops.schedules import num_transfer_tokens_scheduled

TINY = float(np.finfo(np.float32).tiny)


def _filter_logits(logits: torch.Tensor, top_p: Optional[float],
                   top_k: Optional[int]) -> torch.Tensor:
    """top-k / top-p logit filtering (generation_utils.py:31-56)."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the first token above the threshold (the shifted mask)
        kept = (~(cum - probs > top_p)).sum(dim=-1, keepdim=True)
        thresh = torch.gather(sorted_logits, -1, (kept - 1).clamp_min(0))
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def gumbel(shape, generator: Optional[torch.Generator], device
           ) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in [tiny, 1) (the
    noise of jax.random.categorical)."""
    return -torch.log(-torch.log(_uniform(shape, device, generator,
                                          low=TINY)))


def sample_tokens(
    logits: torch.Tensor,
    temperature: float = 0.0,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    margin_confidence: bool = False,
    neg_entropy: bool = False,
    generator: Optional[torch.Generator] = None,
    gumbel_noise: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(confidence [...], x0 [...]) over logits [..., V]
    (generation_utils.py:58-93).  At temperature > 0, x0 is the categorical
    draw argmax(logits / T + g) with g the Gumbel noise `gumbel_noise`
    [..., V], or drawn from `generator`."""
    logits = logits.float()
    if temperature > 0:
        logits = logits / temperature
    logits = _filter_logits(logits, top_p, top_k)
    probs = torch.softmax(logits, dim=-1)
    if temperature > 0:
        if gumbel_noise is None:
            gumbel_noise = gumbel(logits.shape, generator, logits.device)
        x0 = torch.argmax(logits + gumbel_noise, dim=-1)
        confidence = torch.gather(probs, -1, x0[..., None])[..., 0]
    else:
        x0 = torch.argmax(logits, dim=-1)
        confidence = probs.amax(dim=-1)
    if margin_confidence:
        # the top-2 margin by two max passes over the vocabulary, exactly
        # one argmax instance masked (dream_sampler.py:82-92)
        i1 = torch.argmax(probs, dim=-1)
        m1 = torch.gather(probs, -1, i1[..., None])[..., 0]
        masked = probs - torch.nn.functional.one_hot(
            i1, probs.shape[-1]).to(probs.dtype) * 2.0
        confidence = m1 - masked.amax(dim=-1)
    if neg_entropy:
        confidence = torch.sum(probs * torch.log(probs + 1e-10), dim=-1)
    return confidence, x0


def build_dream_schedule(gen: DreamGenerationConfig, gen_length: int
                         ) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side control tables (dream_sampler.py:95-137): (timesteps
    [steps0 + 1], k_counts [steps] (zeros for "origin"), steps).  The mask
    count starts at gen_length - 1: the first token comes from the
    prefill."""
    steps0 = min(gen.steps, gen.max_new_tokens)
    timesteps = np.linspace(1.0, gen.eps, steps0 + 1)
    steps = (int(gen.max_new_tokens * gen.step_ratio)
             if gen.step_ratio is not None else steps0)
    # step_ratio shortens the loop over the same steps0 grid; clamped to it
    steps = max(1, min(steps, steps0))
    m0 = gen_length - 1 if gen.prefix_lm else gen_length
    if gen.alg == "origin":
        return timesteps, np.zeros((steps,), np.int64), steps
    if gen.schedule is not None:
        sch = num_transfer_tokens_scheduled(
            np.array([m0]), steps, gen.schedule, shift=gen.schedule_shift)[0]
        if sch.shape[0] < steps:
            sch = np.concatenate([sch, np.zeros((steps - sch.shape[0],),
                                                np.int64)])
        return timesteps, sch, steps
    # the vanilla cascade (generation_utils.py:500-503), deterministic
    ks, m = [], m0
    for i in range(steps):
        t, s = timesteps[i], timesteps[i + 1]
        n = int(m * (1 - s / t)) if i < steps - 1 else m
        ks.append(n)
        m -= n
    return timesteps, np.asarray(ks, np.int64), steps


def _commit_step(x, logits, mask_index, k_i, p_i, alg, alg_temp,
                 temperature, top_p, top_k, generator=None, noise=None):
    """One denoise commit (generation_utils.py:476-515).  x [B, G];
    logits [B, G, V] (shifted); k_i and p_i 0-d tensors of the step's
    transfer count and origin probability.  noise: (Gumbel noise of the
    categorical draw [B, G, V] or None, the transfer draws [B, G] or
    None); what is None is drawn from `generator` when needed."""
    g_x0, u = noise if noise is not None else (None, None)
    if alg == "origin":
        _, x0 = sample_tokens(logits, temperature, top_p, top_k,
                              generator=generator, gumbel_noise=g_x0)
        if u is None:
            u = _uniform(x.shape, x.device, generator)
        transfer = mask_index & (u < p_i)
        return torch.where(transfer, x0.to(x.dtype), x)
    conf, x0 = sample_tokens(
        logits, temperature, top_p, top_k,
        margin_confidence=(alg == "topk_margin"),
        neg_entropy=(alg == "entropy"), generator=generator,
        gumbel_noise=g_x0)
    conf = torch.where(mask_index, conf, NEG_INF)
    if alg_temp is not None and alg_temp > 0:
        # multinomial without replacement == Gumbel top-k
        logp = torch.log_softmax(
            torch.where(mask_index, conf / alg_temp, NEG_INF), dim=-1)
        if u is None:
            u = _uniform(conf.shape, conf.device, generator, low=1e-20)
        conf = torch.where(mask_index, logp - torch.log(-torch.log(u)),
                           NEG_INF)
    k_row = k_i.expand(x.shape[0])
    transfer = topk_transfer_mask(conf, k_row) & mask_index
    return torch.where(transfer, x0.to(x.dtype), x)


def _prefill(model: LLaDA, prefix: torch.Tensor, G: int, use_flash: bool,
             act_int8: bool):
    """The prefix [B, P, D] into preallocated [B, P+G] buffers; returns
    (x [B, G]: the prefill's argmax first, masks after it, the cache)."""
    B, P, _ = prefix.shape
    cfg = model.cfg
    shape = (B, P + G, model.kv_heads, cfg.head_dim)
    cache = [(prefix.new_zeros(shape), prefix.new_zeros(shape))
             for _ in model.blocks]
    logits, cache = model(prefix, kv_cache=cache, kv_write_index=0,
                          use_cache=True, last_logits_only=True,
                          use_flash=use_flash, act_int8=act_int8)
    x = torch.full((B, G), cfg.mask_token_id, dtype=torch.long,
                   device=prefix.device)
    x[:, 0] = torch.argmax(logits[:, -1], dim=-1)
    return x, cache


def _shifted_logits(model: LLaDA, x: torch.Tensor, cache: list, P: int
                    ) -> torch.Tensor:
    """One decode step's logits [B, G, V] (the write-index decode over the
    cache: the decode kernel on the card, dense on the CPU), shifted one
    position right."""
    G = x.shape[1]
    logits, _ = model(model.embed_tokens(x),
                      positions=torch.arange(P, P + G, device=x.device),
                      kv_cache=cache, kv_write_index=P, use_cache=True)
    return torch.cat([logits[:, :1], logits[:, :-1]], dim=1)


def _dream_fused(model, prefix, k_table, p_transfer, generator, G, gen,
                 use_flash_prefill, act_int8_prefill):
    """The serving loop (dream_sampler.py:140-264, the write-index
    branch): prefill, then one decode and commit per row of the tables."""
    P = prefix.shape[1]
    x, cache = _prefill(model, prefix, G, use_flash_prefill,
                        act_int8_prefill)
    mask_id = model.cfg.mask_token_id
    for i in range(k_table.shape[0]):
        mask_index = x == mask_id
        logits = _shifted_logits(model, x, cache, P)
        x = _commit_step(x, logits, mask_index, k_table[i], p_transfer[i],
                         gen.alg, gen.alg_temp, gen.temperature, gen.top_p,
                         gen.top_k, generator)
    return x


def _dream_hooked(model, prefix, k_table, p_transfer, generator, G, gen,
                  use_flash_prefill, tokens_hook, logits_hook, verbose):
    """The loop with the reference's hooks (dream_sampler.py:267-312):
    `tokens_hook(step, x, logits)` before the loop (step None) and after
    each commit, `logits_hook(step, x, logits)` on each step's shifted
    logits; the prefill runs the decode linears.  Returns x, or (x, the
    token buffer after each step as numpy arrays) when verbose."""
    tokens_hook = tokens_hook or (lambda step, x, logits: x)
    logits_hook = logits_hook or (lambda step, x, logits: logits)
    P = prefix.shape[1]
    x, cache = _prefill(model, prefix, G, use_flash_prefill, False)
    mask_id = model.cfg.mask_token_id

    def tokens(step, x, logits):
        return torch.as_tensor(tokens_hook(step, x, logits),
                               device=x.device).long()

    x = tokens(None, x, None)              # generation_utils.py:451
    history = []
    for i in range(k_table.shape[0]):
        mask_index = x == mask_id
        logits = logits_hook(i, x, _shifted_logits(model, x, cache, P))
        x = _commit_step(x, logits, mask_index, k_table[i], p_transfer[i],
                         gen.alg, gen.alg_temp, gen.temperature, gen.top_p,
                         gen.top_k, generator)
        x = tokens(i, x, logits)
        if verbose:
            history.append(x.cpu().numpy())
    return (x, history) if verbose else x


@torch.no_grad()
def dream_generate(
    model: LLaDA,
    prefix_embeds: torch.Tensor,
    gen: DreamGenerationConfig,
    *,
    generator: Optional[torch.Generator] = None,
    use_flash_prefill: bool = False,
    tokens_hook=None,
    logits_hook=None,
    verbose: bool = False,
    act_int8_prefill: bool = False,
):
    """Generate with the Dream sampler after prefix_embeds [B, P, D].
    Returns [B, max_new_tokens] ids (or (ids, history) when verbose).

    use_flash_prefill: the prefill's attention through the short-attention
    kernel (bench.py's serving path); the decode attends over the bf16
    cache through the decode kernel on the card and densely on the CPU
    (the JAX package's write-index branch: plain XLA).  tokens_hook /
    logits_hook / verbose: the reference's sampler extension surface
    (generation_utils.py:308-309), run by `_dream_hooked`.
    act_int8_prefill: the mixed layout's split (the int8 prefill tree and
    its head prefill, the decode linears denoise); it is wired on the
    hook-free path only, as in the JAX package."""
    gen = as_port_config(gen)
    if not gen.prefix_lm:
        raise NotImplementedError(
            "the Dream sampler implements the prefix-cache mode only (the "
            "reference eval configs always use it; run_dream.sh:13)")
    device = prefix_embeds.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    G = gen.max_new_tokens
    timesteps, ks, steps = build_dream_schedule(gen, G)
    t = timesteps[:steps]
    s = timesteps[1:steps + 1]
    p_transfer = (1.0 - s / t).astype(np.float32)
    if steps > 0:
        p_transfer[-1] = 1.0  # the last step commits everything (origin)
    k_table = torch.as_tensor(ks, device=device)
    p_table = torch.as_tensor(p_transfer, device=device)
    if tokens_hook is not None or logits_hook is not None or verbose:
        if act_int8_prefill:
            raise NotImplementedError(
                "the mixed-precision prefill is wired on the hook-free "
                "Dream path only: drop the hooks / verbose or the mixed "
                "flag")
        return _dream_hooked(model, prefix_embeds, k_table, p_table,
                             generator, G, gen, use_flash_prefill,
                             tokens_hook, logits_hook, verbose)
    return _dream_fused(model, prefix_embeds, k_table, p_table, generator, G,
                        gen, use_flash_prefill, act_int8_prefill)
