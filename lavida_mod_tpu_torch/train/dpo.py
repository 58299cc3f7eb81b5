"""DPO for the masked-diffusion LM: the port of lavida_mod_tpu/train/dpo.py.

The reference trains DPO through its vendored trl with AR sequence
log-probs.  A diffusion LM has no exact sequence log-prob, so the JAX
package uses the masked-CE ELBO proxy of llada/log_likelyhood.py, and so
does the port:

  L = -log sigmoid( beta * [ (lp_c - lp_r) - (lp_c_ref - lp_r_ref) ] )

with lp_* the per-row estimates.  The SAME mask pattern and t serve the
policy and the reference on each side of a pair, so their difference
cancels the mask-sampling noise to first order.  The two patterns come
from a `torch.Generator` (chosen first, then rejected); `masks` injects
them, which is how a test gives the port JAX's jax.random draws.

The policy and the reference are the port's `LLaDA` modules.  The
reference's passes run without autograd (JAX's stop_gradient).  With
`reference=None` the reference is the policy with its LoRA factors
switched off (`lora_off`): one frozen base serves both, and at the start
of training (LoRA B = 0) policy == reference.

The second half is trl's AR DPO, exact (dpo_trainer.py:731-959):
`ar_batch_logps`, `ar_dpo_loss` (sigmoid / hinge / ipo / kto_pair, label
smoothing, reference-free) and `ar_dpo_batch_loss` (dpo_alpha x DPO +
gamma x the chosen side's SFT cross-entropy), over any `forward_fn(params,
ids) -> logits [B, L, V]`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.quant import has_lora
from .loss import forward_process
from .step import Optimizer, TrainState, _microstep


@contextlib.contextmanager
def lora_off(model: torch.nn.Module):
    """Inside the context every linear of `model` runs without its LoRA
    factors (they are set aside and put back on exit)."""
    held = [(m, m.lora_a) for m in model.modules() if has_lora(m)]
    for m, _ in held:
        m._parameters["lora_a"] = None
    try:
        yield model
    finally:
        for m, a in held:
            m._parameters["lora_a"] = a


def _masked_ce_logp(lm, embeds, labels, masked_indices, p_mask,
                    prefix_lengths=None, remat=True,
                    attention_impl: str = "dense") -> torch.Tensor:
    """Per-row negative weighted masked CE (an ELBO log-prob proxy,
    dpo.py:29-50): -(1/|answer|) * sum CE(masked) / p_mask."""
    sup = labels != -100
    final = masked_indices & sup
    mask_embed = lm.embed_tokens(torch.tensor(
        [lm.cfg.mask_token_id], device=embeds.device)).reshape(1, 1, -1).to(
        embeds.dtype)
    x = torch.where(final[..., None], mask_embed, embeds)
    logits, _ = lm(x, prefix_lengths=prefix_lengths, remat=remat,
                   attention_impl=attention_impl)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.where(sup, labels, 0)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    w = torch.where(final, 1.0 / p_mask, 0.0)
    denom = sup.sum(dim=-1).clamp(min=1)
    return -(nll * w).sum(dim=-1) / denom          # [B]


def dpo_loss(policy, reference, chosen_embeds: torch.Tensor,
             chosen_labels: torch.Tensor, rejected_embeds: torch.Tensor,
             rejected_labels: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             beta: float = 0.1, prefix_lm: bool = True, remat=True,
             masks=None, attention_impl: str = "dense"):
    """(loss, metrics) of dpo.py:53-98 on embeds [B, L, D] and labels
    [B, L] (-100 = not supervised).  `reference`: an LLaDA, or None for
    the policy without its LoRA factors.  `masks`: ((mc, pc), (mr, pr)) in
    place of the generator's draws."""
    B, L, _ = chosen_embeds.shape
    if masks is None:
        if generator is None:
            raise ValueError("dpo_loss draws its masks from a generator: "
                             "give one, or masks")
        # chosen, then rejected (dpo.py:67-69)
        masks = (forward_process(generator, B, L),
                 forward_process(generator, B, L))
    dev = chosen_embeds.device
    (mc, pc), (mr, pr) = [(m.to(dev), p.to(dev)) for m, p in masks]
    chosen_labels = chosen_labels.to(dev)
    rejected_labels = rejected_labels.to(dev)

    def pls(labels):
        if not prefix_lm:
            return None
        return torch.argmax((labels != -100).to(torch.int32), dim=1)

    kw = dict(remat=remat, attention_impl=attention_impl)
    lp_c = _masked_ce_logp(policy, chosen_embeds, chosen_labels, mc, pc,
                           pls(chosen_labels), **kw)
    lp_r = _masked_ce_logp(policy, rejected_embeds, rejected_labels, mr, pr,
                           pls(rejected_labels), **kw)
    ref = contextlib.nullcontext(reference) if reference is not None \
        else lora_off(policy)
    with torch.no_grad(), ref as ref_lm:
        ref_c = _masked_ce_logp(ref_lm, chosen_embeds, chosen_labels, mc, pc,
                                pls(chosen_labels), **kw)
        ref_r = _masked_ce_logp(ref_lm, rejected_embeds, rejected_labels, mr,
                                pr, pls(rejected_labels), **kw)
    margin = (lp_c - lp_r) - (ref_c - ref_r)
    logits = beta * margin
    loss = -F.logsigmoid(logits).mean()
    metrics = {
        "dpo_loss": loss,
        "reward_margin": margin.mean(),
        "reward_acc": (logits > 0).float().mean(),
        "logp_chosen": lp_c.mean(),
        "logp_rejected": lp_r.mean(),
    }
    return loss, metrics


def make_dpo_train_step(cfg, optimizer: Optimizer, reference=None, *,
                        beta: float = 0.1, prefix_lm: bool = True,
                        remat=True, attention_impl: str = "dense"):
    """dpo.py:101-127 on the port's state: train_step(state, batch,
    generator=None, masks=None) -> metrics (dpo_loss's, plus grad_norm,
    JAX's global norm over every leaf, as the other steps take it), the
    state updated in place.  batch = {"chosen_embeds", "chosen_labels",
    "rejected_embeds", "rejected_labels"}; the state's model is an LLaDA
    or a LaViDa (its LM trains; the embeds are given).  `reference`: an
    LLaDA, or None for the policy without its LoRA factors."""

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   masks=None) -> dict:
        state.load_masters()
        lm = getattr(state.model, "llada", state.model)
        dt = lm.wte.weight.dtype

        def forward():
            loss, metrics = dpo_loss(
                lm, reference, batch["chosen_embeds"].to(dt),
                batch["chosen_labels"], batch["rejected_embeds"].to(dt),
                batch["rejected_labels"], generator, beta=beta,
                prefix_lm=prefix_lm, remat=remat, masks=masks,
                attention_impl=attention_impl)
            return loss, dict(metrics)

        return _microstep(state, optimizer, forward)

    return train_step


# ---------------------------------------------------------------------------
# trl-exact AR DPO (for causal AR baselines)
# ---------------------------------------------------------------------------

def ar_batch_logps(logits: torch.Tensor, labels: torch.Tensor, *,
                   average_log_prob: bool = False,
                   label_pad_token_id: int = -100) -> torch.Tensor:
    """trl get_batch_logps (dpo_trainer.py:797-836): labels shifted left,
    logits right, per-token log-probs summed (or averaged) over the
    non-padded positions.  -> [B] f32."""
    labels = labels[:, 1:]
    logits = logits[:, :-1, :]
    loss_mask = labels != label_pad_token_id
    tgt = torch.where(loss_mask, labels, 0)
    logps = torch.log_softmax(logits.float(), dim=-1)
    per_tok = logps.gather(-1, tgt[..., None])[..., 0]
    summed = (per_tok * loss_mask).sum(-1)
    if average_log_prob:
        return summed / loss_mask.sum(-1).clamp(min=1)
    return summed


def ar_dpo_loss(policy_chosen_logps: torch.Tensor,
                policy_rejected_logps: torch.Tensor,
                reference_chosen_logps: torch.Tensor,
                reference_rejected_logps: torch.Tensor, *,
                beta: float = 0.1, label_smoothing: float = 0.0,
                loss_type: str = "sigmoid", reference_free: bool = False):
    """trl dpo_loss (dpo_trainer.py:731-795) -> (per-example losses,
    chosen_rewards, rejected_rewards)."""
    pi_logratios = policy_chosen_logps - policy_rejected_logps
    ref_logratios = (torch.zeros_like(pi_logratios) if reference_free else
                     reference_chosen_logps - reference_rejected_logps)
    logits = pi_logratios - ref_logratios
    if loss_type == "sigmoid":
        losses = (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
                  - F.logsigmoid(-beta * logits) * label_smoothing)
    elif loss_type == "hinge":
        losses = torch.relu(1 - beta * logits)
    elif loss_type == "ipo":
        losses = (logits - 1 / (2 * beta)) ** 2
    elif loss_type == "kto_pair":
        chosen_kl = (policy_chosen_logps
                     - reference_chosen_logps).mean().clamp(min=0)
        rejected_kl = (policy_rejected_logps
                       - reference_rejected_logps).mean().clamp(min=0)
        chosen_lr = policy_chosen_logps - reference_chosen_logps
        rejected_lr = policy_rejected_logps - reference_rejected_logps
        losses = torch.cat([
            1 - torch.sigmoid(beta * (chosen_lr - rejected_kl)),
            1 - torch.sigmoid(beta * (chosen_kl - rejected_lr))], dim=0)
    else:
        raise ValueError(f"Unknown loss type: {loss_type}")
    chosen_rewards = (beta * (policy_chosen_logps
                              - reference_chosen_logps)).detach()
    rejected_rewards = (beta * (policy_rejected_logps
                                - reference_rejected_logps)).detach()
    return losses, chosen_rewards, rejected_rewards


def ar_dpo_batch_loss(forward_fn: Callable, params, ref_params, batch: dict,
                      *, beta: float = 0.1, dpo_alpha: float = 1.0,
                      gamma: float = 0.0, loss_type: str = "sigmoid",
                      label_smoothing: float = 0.0):
    """trl's batch objective (dpo_trainer.py:946-959): dpo_alpha x DPO +
    gamma x the SFT cross-entropy of the chosen response, with
    `forward_fn(params, ids) -> logits [B, L, V]`; the reference's
    log-probs are detached.  batch: chosen_ids / chosen_labels /
    rejected_ids / rejected_labels [B, L]."""
    avg = loss_type == "ipo"    # trl averages the log-probs for IPO (:877)

    def lp(p, ids, labels):
        logits = forward_fn(p, ids)
        return ar_batch_logps(logits, labels, average_log_prob=avg), logits

    pc, chosen_logits = lp(params, batch["chosen_ids"],
                           batch["chosen_labels"])
    pr, _ = lp(params, batch["rejected_ids"], batch["rejected_labels"])
    rc, _ = lp(ref_params, batch["chosen_ids"], batch["chosen_labels"])
    rr, _ = lp(ref_params, batch["rejected_ids"], batch["rejected_labels"])
    rc, rr = rc.detach(), rr.detach()

    losses, chosen_rw, rejected_rw = ar_dpo_loss(
        pc, pr, rc, rr, beta=beta, label_smoothing=label_smoothing,
        loss_type=loss_type)

    # SFT CE over the shifted chosen labels (get_sft_loss, :838-850)
    labels = batch["chosen_labels"][:, 1:]
    logits = chosen_logits[:, :-1].float()
    mask = labels != -100
    tgt = torch.where(mask, labels, 0)
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, tgt[..., None])[..., 0]
    sft = (ce * mask).sum() / mask.sum().clamp(min=1)

    loss = dpo_alpha * losses.mean() + gamma * sft
    metrics = {
        "dpo_loss": losses.mean(),
        "sft_loss": sft,
        "rewards_chosen": chosen_rw.mean(),
        "rewards_rejected": rejected_rw.mean(),
        "reward_acc": (chosen_rw > rejected_rw).float().mean(),
        "reward_margin": (chosen_rw - rejected_rw).mean(),
    }
    return loss, metrics
