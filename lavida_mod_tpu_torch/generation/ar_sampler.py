"""Autoregressive sampler of the AR-LLaVA baselines, the port of
lavida_mod_tpu/generation/ar_sampler.py (`ar_generate_fused`,
ar_sampler.py:22-93).

One causal prefill over the prefix embeddings, written into [B, P + G]
key/value buffers allocated once (`kv_write_index=0`; the G unwritten rows
masked), the logits of its last row only; then G - 1 decode steps, each
writing its one row in place at `kv_write_index = P + i` under the causal
mask.  Greedy (temperature 0: argmax of the f32 logits) or sampled:
logits / temperature, the top_k largest kept (the rest set to -1e30), and
`jax.random.categorical`'s rule, argmax(logits + Gumbel noise).  The noise
comes from `generator` (-log(-log(u)), u uniform in [tiny, 1)) or, for
tests, from `gumbel` [G, B, V] (step 0 the first token's draw), so the
JAX package's own draws can be replayed.  A row that has emitted `eos`
keeps emitting `eos` (ar_sampler.py:80-82).

The LLaDA module runs in any of its layouts (bf16, `to_fused_layout`,
int8 / grouped int4): at B = 1 the decode's single row declines the fused
W4 plan (rows % 8 != 0, llada.py:163), so the int4 layout's linears run
through `w4_matmul_grouped`'s decode kernel, and the prefill's rows through
its prefill kernel.  Causal attention is the dense path (as in the JAX
package, where it is plain XLA).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import NEG_INF


def _gumbel(shape, generator, device) -> torch.Tensor:
    """jax.random.gumbel's transform of uniforms in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def sample(logits: torch.Tensor, temperature: float, top_k: Optional[int],
           noise: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, V] logits -> [B] tokens (ar_sampler.py:61-69)."""
    logits = logits.float()
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    return (noise + logits).argmax(dim=-1)


@torch.no_grad()
def ar_generate_fused(
    model,
    prefix_embeds: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    return_logits: bool = False,
):
    """Greedy or temperature / top-k decode of `model` (a port LLaDA) from
    prefix_embeds [B, P, D].  Returns the [B, G] tokens (int64), and with
    return_logits also the f32 logits each token was drawn from [B, G, V].
    generator: the noise of temperature > 0 (default: seed 0 on the
    prefix's device); gumbel [G, B, V]: that noise given instead."""
    B, P, _ = prefix_embeds.shape
    G = max_new_tokens
    device = prefix_embeds.device
    eos = model.cfg.eos_token_id if eos_id is None else eos_id
    if temperature != 0.0 and gumbel is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def draw(logits, i):
        noise = None
        if temperature != 0.0:
            noise = (gumbel[i].to(device) if gumbel is not None else
                     _gumbel(logits.shape, generator, device))
        return sample(logits, temperature, top_k, noise)

    Hkv, hd = model.kv_heads, model.cfg.head_dim
    cache = [(prefix_embeds.new_zeros(B, P + G, Hkv, hd),
              prefix_embeds.new_zeros(B, P + G, Hkv, hd))
             for _ in model.blocks]
    logits, _ = model(prefix_embeds, kv_cache=cache, kv_write_index=0,
                      use_cache=True, last_logits_only=True, causal=True)
    tok = draw(logits[:, -1], 0)
    toks, all_logits = [tok], [logits[:, -1]]
    finished = tok == eos
    for i in range(G - 1):
        logits, _ = model(model.embed_tokens(tok[:, None]), kv_cache=cache,
                          kv_write_index=P + i, use_cache=True, causal=True)
        nxt = draw(logits[:, -1], i + 1)
        tok = torch.where(finished, torch.full_like(nxt, eos), nxt)
        finished = finished | (tok == eos)
        toks.append(tok)
        all_logits.append(logits[:, -1])
    out = torch.stack(toks, dim=1)
    if return_logits:
        return out, torch.stack(all_logits, dim=1)
    return out
