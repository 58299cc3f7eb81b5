"""Masked-diffusion training loss with complementary masking: the port of
lavida_mod_tpu/train/loss.py (reference llava_llada.py:105-258 and
modeling_llada.py:1519-1549).

  1. sample t per row (uniform / logit_normal / mode), p_mask = (1 - eps)
     t + eps;
  2. mask the positions where rand <= max(p_mask, the row's smallest rand),
     so every row masks at least one position;
  3. complementary masking: the batch is doubled with the inverse mask, so
     every target token is supervised exactly once per sample;
  4. masked positions' embeddings become wte([MASK]);
  5. prefix_lengths = argmax(labels_mask) per row, the prefix-LM mask;
  6. loss = mean cross-entropy over the supervised (non -100) positions,
     FIM marker labels killed, no 1 / p_mask weighting.

All randomness comes from an explicit `torch.Generator` (on the device the
loss runs on); the two packages draw different numbers, so a test injects
JAX's mask through `masked_indices`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def sample_t(generator: torch.Generator, b: int, policy: str = "uniform",
             policy_args: Optional[dict] = None) -> torch.Tensor:
    """[b] diffusion times on the generator's device (loss.py:39-55)."""
    dev = generator.device
    if policy == "uniform":
        return torch.rand(b, generator=generator, device=dev)
    if policy == "logit_normal":
        a = policy_args or {"logit_mean": 0.0, "logit_std": 1.0}
        u = a["logit_mean"] + a["logit_std"] * torch.randn(
            b, generator=generator, device=dev)
        return torch.sigmoid(u)
    if policy == "mode":
        a = policy_args or {"mode_scale": 1.0}
        u = torch.rand(b, generator=generator, device=dev)
        return 1.0 - u - a["mode_scale"] * (
            torch.cos(math.pi * u / 2.0) ** 2 - 1.0 + u)
    raise NotImplementedError(policy)


def forward_process(generator: torch.Generator, b: int, l: int,
                    eps: float = 1e-3, policy: str = "uniform",
                    policy_args: Optional[dict] = None):
    """(masked_indices [b, l] bool, p_mask [b, 1] f32) (loss.py:58-68)."""
    t = sample_t(generator, b, policy, policy_args)
    p_mask = ((1.0 - eps) * t + eps)[:, None]
    r = torch.rand(b, l, generator=generator, device=generator.device)
    cutoff = torch.maximum(p_mask, r.amin(dim=-1, keepdim=True))
    return r <= cutoff, p_mask


def _head_chunk(h_c, weight, t_c, s_c):
    """One ce_chunk of the head: a dot in the hidden state's dtype, then f32
    (loss.py:182-190).  -> (sum of nll over supervised rows, hits)."""
    lg = (h_c @ weight.to(h_c.dtype).t()).float()          # [2B, c, V]
    nll = -torch.log_softmax(lg, dim=-1).gather(-1, t_c[..., None])[..., 0]
    hit = (lg.argmax(dim=-1) == t_c) & s_c
    return torch.where(s_c, nll, 0.0).sum(), hit.sum()


def diffusion_loss(
    lm,
    inputs_embeds: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    prefix_lm: bool = True,
    policy: str = "uniform",
    policy_args: Optional[dict] = None,
    masked_indices: Optional[torch.Tensor] = None,
    fim_id: Optional[int] = None,
    pos_skip_range: int = 0,
    remat=True,
    use_flash: bool = False,
    attention_impl: str = "dense",
    ce_chunk: Optional[int] = None,
):
    """(loss, metrics) of the port's `LLaDA` `lm` on spliced embeddings
    [B, L, D] with labels [B, L] (-100 = not supervised); the batch is
    doubled inside.  `masked_indices` [B, L] bool replaces the sampled mask
    (test injection).  `ce_chunk`: the head and its cross-entropy in
    checkpointed chunks of that many positions, so the f32 [2B, L, V]
    logits never exist whole.  Metrics: loss, acc_mask, num_supervised
    (0-d tensors)."""
    B, L, D = inputs_embeds.shape
    device = inputs_embeds.device
    labels = labels.to(device)
    labels_mask = labels != -100
    fim_pos = (labels == fim_id if fim_id is not None
               else torch.zeros_like(labels_mask))
    if masked_indices is None:
        if generator is None:
            raise ValueError("diffusion_loss draws its mask from a "
                             "generator: give one, or masked_indices")
        masked_indices, _ = forward_process(generator, B, L, policy=policy,
                                            policy_args=policy_args)
    masked_indices = masked_indices.to(device)
    final_masked = masked_indices & labels_mask & ~fim_pos
    final_masked_inv = ~masked_indices & labels_mask & ~fim_pos

    mask_embed = lm.embed_tokens(torch.tensor(
        [lm.cfg.mask_token_id], device=device)).reshape(1, 1, D).to(
        inputs_embeds.dtype)
    embeds2 = torch.cat([
        torch.where(sel[..., None], mask_embed, inputs_embeds)
        for sel in (final_masked, final_masked_inv)])
    labels2 = torch.cat([torch.where(final_masked, labels, -100),
                         torch.where(final_masked_inv, labels, -100)])
    if fim_id is not None:
        labels2 = torch.where(labels2 == fim_id, -100, labels2)

    prefix_lengths = None
    if prefix_lm:
        pl = torch.argmax(labels_mask.to(torch.int32), dim=1)
        prefix_lengths = torch.cat([pl, pl])
    positions = None
    if pos_skip_range > 0:
        # use_pos_skipping (llava_arch.py:894-900): every position shifted
        # by one random offset; the mask keeps using sequence indices
        offset = torch.randint(0, pos_skip_range, (), generator=generator,
                               device=generator.device)
        positions = offset.to(device) + torch.arange(L, device=device)
    sup = labels2 != -100
    tgt = torch.where(sup, labels2, 0)
    denom = sup.sum().clamp(min=1)
    fwd = dict(positions=positions, prefix_lengths=prefix_lengths,
               remat=remat, use_flash=use_flash,
               attention_impl=attention_impl)

    if ce_chunk:
        hidden, _ = lm(embeds2, return_logits=False, **fwd)
        c = int(ce_chunk)
        Lp = -(-L // c) * c
        hidden = F.pad(hidden, (0, 0, 0, Lp - L))
        tgt_p, sup_p = F.pad(tgt, (0, Lp - L)), F.pad(sup, (0, Lp - L))
        record = torch.is_grad_enabled()
        nll_sum = hits = 0
        for i in range(0, Lp, c):
            args = (hidden[:, i:i + c], lm.ff_out.weight, tgt_p[:, i:i + c],
                    sup_p[:, i:i + c])
            n, h = (checkpoint(_head_chunk, *args, use_reentrant=False)
                    if record else _head_chunk(*args))
            nll_sum, hits = nll_sum + n, hits + h
        loss = nll_sum / denom
        return loss, {"loss": loss, "acc_mask": hits / denom,
                      "num_supervised": sup.sum()}

    logits, _ = lm(embeds2, **fwd)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    loss = torch.where(sup, nll, 0.0).sum() / denom
    acc = (sup & (logits.argmax(dim=-1) == tgt)).sum() / denom
    return loss, {"loss": loss, "acc_mask": acc, "num_supervised": sup.sum()}
