"""Sampling ops of the masked-diffusion denoise loop: the port of
lavida_mod_tpu/ops/sampling.py (reference generate.py:8-19, :278-311).

Every op is shape-static and stays on the device: the reference's per-row
`torch.topk` loop becomes a rank-based masked select.  Randomness (gumbel
noise at temperature > 0, `random` remasking) comes from an explicit
`torch.Generator`; it does not reproduce jax.random's bits, so parity with
the JAX package is token-exact only at temperature 0 with a non-random
remasking.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _uniform(shape, device, generator: torch.Generator | None,
             low: float = 0.0) -> torch.Tensor:
    if generator is None:
        raise ValueError("sampling at temperature > 0 or with random "
                         "remasking needs a torch.Generator")
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return low + (1.0 - low) * u


def add_gumbel_noise(logits: torch.Tensor, temperature: float,
                     generator: torch.Generator | None) -> torch.Tensor:
    """LLaDA's gumbel-max variant exp(logits) / (-log u) ** temperature;
    the logits unchanged at temperature 0."""
    if temperature == 0:
        return logits
    logits = logits.float()
    noise = _uniform(logits.shape, logits.device, generator, low=1e-12)
    return torch.exp(logits) / (-torch.log(noise)) ** temperature


def remasking_confidence(logits: torch.Tensor, x0: torch.Tensor,
                         remasking: str,
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """Per-position confidence [B, T] f32 from logits [B, T, V] and the
    argmax tokens x0 [B, T]."""
    logits = logits.float()
    if remasking == "low_confidence":
        p = torch.softmax(logits, dim=-1)
        return torch.gather(p, -1, x0[..., None])[..., 0]
    if remasking == "random":
        return _uniform(x0.shape, x0.device, generator)
    if remasking == "entrophy":  # sic: the reference's spelling
        p = torch.softmax(logits, dim=-1)
        return torch.sum(p * torch.log(p + 1e-10), dim=-1)
    if remasking == "margin":
        p = torch.softmax(logits, dim=-1)
        i1 = torch.argmax(p, dim=-1)
        m1 = torch.gather(p, -1, i1[..., None])[..., 0]
        m2 = torch.amax(p - 2.0 * torch.nn.functional.one_hot(
            i1, p.shape[-1]).to(p.dtype), dim=-1)
        return m1 - m2
    raise NotImplementedError(remasking)


def topk_transfer_mask(confidence: torch.Tensor,
                       k_per_row: torch.Tensor) -> torch.Tensor:
    """[B, T] bool: each row's top-k_per_row[b] confidences, by a double
    STABLE argsort, so ties break by position as jnp.argsort does
    (torch.topk breaks them differently)."""
    order = torch.argsort(-confidence, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < k_per_row[:, None]


def denoise_commit(
    x: torch.Tensor,
    logits: torch.Tensor,
    mask_index: torch.Tensor,
    k_per_row: torch.Tensor,
    block_end: torch.Tensor | int,
    temperature: float = 0.0,
    remasking: str = "low_confidence",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One denoise commit (generate.py:274-311): pick x0, score it, and
    transfer the top-k masked positions before `block_end`.

    x [B, T] tokens; logits [B, T, V]; mask_index [B, T] bool; k_per_row
    [B]; block_end a scalar (positions >= it get confidence -inf).
    """
    if temperature == 0:
        x0 = torch.argmax(logits, dim=-1)
    else:
        x0 = torch.argmax(add_gumbel_noise(logits, temperature, generator),
                          dim=-1)
    conf = remasking_confidence(logits, x0, remasking, generator)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    neg = torch.full_like(conf, NEG_INF)
    conf = torch.where((pos >= block_end) | ~mask_index, neg, conf)
    x0 = torch.where(mask_index, x0.to(x.dtype), x)
    return torch.where(topk_transfer_mask(conf, k_per_row), x0, x)
