"""The training step: complementary-masking diffusion loss and an
optax-equivalent AdamW, the port of lavida_mod_tpu/train/step.py.

The optimizer is written out as plain tensor functions in optax's order,
not torch.optim: per LR group a chain of
    clip_by_global_norm(grad_clip)            (the GROUP's norm)
    -> scale_by_adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
       u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
    -> add_decayed_weights: u + wd * p
    -> scale by -lr(count), count the group's updates before this one
and p <- p + u.  Groups are labelled by top-level module as
optax.multi_transform labels them (step.py:54-65, 341-352): "projector",
"vision_tower", "base", and "frozen" for a part left out of
`tunable_parts`.  Gradient accumulation keeps optax.MultiSteps' running
mean a + (g - a) / (i + 1) and runs the inner chain every k-th microstep
only, so the schedule counts optimizer updates; `accum_dtype=torch.float32`
keeps that mean in f32 whatever the parameters' dtype (multi_steps_f32,
step.py:106-152).

The mixed-precision policy (the JAX step's `compute_dtype=bf16`,
step.py:215-221, 279-283; here `init_train_state(..., compute_dtype=
torch.bfloat16)`, which the step reads from the state) works as
DeepSpeed's bf16 engine: the state holds f32 masters and
f32 Adam moments for the trainable leaves and a bf16 compute model; each
microstep copies the masters into the model, runs forward and backward in
bf16, takes the bf16 leaves' gradients as f32 and updates the masters.
Frozen leaves have requires_grad=False outside a step and no optimizer
state.  The port updates the masters and moments in place, where optax
returns new trees.

`grad_norm` is JAX's metric, optax.global_norm over the gradient of every
leaf, frozen ones included (step.py:247, 314): a step differentiates the
frozen leaves too (their requires_grad is set for its forward and
backward, so a frozen tower runs under autograd as in JAX), sums their
squared gradients into the norm, and frees the gradients; they do not
reach the optimizer.  Sharding (`mesh`, `batch_axes`) is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models.multimodal import multimodal_embeds
from .loss import diffusion_loss


# ---------------------------------------------------------------------------
# schedules (optax's, evaluated at an update count)
# ---------------------------------------------------------------------------

def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """Linear warmup from init_value to peak_value, then cosine decay to
    end_value at decay_steps (the warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


# ---------------------------------------------------------------------------
# AdamW with per-group clipping; multi_transform; MultiSteps
# ---------------------------------------------------------------------------

def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, f32 (0-d)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclass
class AdamW:
    """clip_by_global_norm(grad_clip) -> optax.adamw(lr, b1, b2, eps,
    weight_decay) for one LR group; `lr` maps the update count to the LR."""

    lr: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def apply(self, grads: dict, state: dict, params: dict) -> None:
        """One update of `params` and `state` in place."""
        if not grads:
            return
        norm = global_norm(grads.values())
        clip = norm < self.grad_clip
        count = state["count"]
        n = count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(n))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(n))
        step = -float(np.float32(self.lr(count)))
        b1, b2 = self.b1, self.b2
        for name, g in grads.items():
            p, mu, nu = params[name], state["mu"][name], state["nu"][name]
            g = g.to(p.dtype)
            g = torch.where(clip, g, (g / norm.to(g.dtype)) * self.grad_clip)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(step * u)
        state["count"] = n


class Optimizer:
    """optax.multi_transform over the LR groups, optionally inside
    MultiSteps.  `label(name)` gives a parameter's group by its state-dict
    name; a group missing from `groups` is frozen."""

    def __init__(self, label: Callable[[str], str], groups: dict,
                 grad_accum: int = 1, accum_dtype=None):
        self.label, self.groups = label, groups
        self.grad_accum, self.accum_dtype = max(1, grad_accum), accum_dtype

    def trainable(self, name: str) -> bool:
        return self.label(name) in self.groups

    def init(self, params: dict) -> dict:
        by_group = {g: {n: p for n, p in params.items() if self.label(n) == g}
                    for g in self.groups}
        state = {"groups": {g: t.init(by_group[g])
                            for g, t in self.groups.items()}}
        if self.grad_accum > 1:
            state["mini_step"] = 0
            state["acc"] = {n: torch.zeros_like(p, dtype=self.accum_dtype)
                            for n, p in params.items() if self.trainable(n)}
        return state

    def step(self, grads: dict, state: dict, params: dict) -> bool:
        """One microstep: accumulate `grads` and, at the end of an
        accumulation window (every call when grad_accum is 1), update
        `params` in place.  Returns whether it updated."""
        if self.grad_accum > 1:
            i, acc = state["mini_step"], state["acc"]
            for n, g in grads.items():
                a = acc[n]
                a.add_((g.to(a.dtype) - a) / (i + 1))
            if i < self.grad_accum - 1:
                state["mini_step"] = i + 1
                return False
            grads = {n: a.to(params[n].dtype) for n, a in acc.items()}
            state["mini_step"] = 0
        for g, t in self.groups.items():
            t.apply({n: x for n, x in grads.items() if self.label(n) == g},
                    state["groups"][g], params)
        if self.grad_accum > 1:
            for a in state["acc"].values():
                a.zero_()
        return True


def label_params(name: str) -> str:
    """The LR group of a parameter by its top-level module (step.py:54-65):
    the projector, the vision tower, and the base LR for the rest."""
    top = name.split(".")[0]
    if top == "projector":
        return "projector"
    if top == "siglip":
        return "vision_tower"
    return "base"


def _adamw_builder(weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, warmup_steps: int = 0,
                   total_steps: int = 10000, min_lr_ratio: float = 0.0,
                   grad_clip: float = 1.0,
                   schedule: str = "cosine_with_min_lr"):
    def sched(base):
        if schedule == "constant":
            return lambda count: base
        if warmup_steps <= 0:
            return cosine_decay_schedule(base, max(total_steps, 1),
                                         alpha=min_lr_ratio)
        return warmup_cosine_decay_schedule(
            0.0, base, warmup_steps, max(total_steps, 2),
            end_value=base * min_lr_ratio)

    return lambda base: AdamW(sched(base), b1=b1, b2=b2,
                              weight_decay=weight_decay, grad_clip=grad_clip)


def make_optimizer(lr: float = 2e-5, projector_lr: Optional[float] = None,
                   vision_tower_lr: Optional[float] = None,
                   grad_accum: int = 1, accum_dtype=None, **kw) -> Optimizer:
    """Every parameter trains: base LR, projector LR, vision-tower LR
    (step.py:175-192)."""
    adamw = _adamw_builder(**kw)
    return Optimizer(label_params, {
        "base": adamw(lr), "projector": adamw(projector_lr or lr),
        "vision_tower": adamw(vision_tower_lr or lr)}, grad_accum,
        accum_dtype)


def make_freeze_optimizer(tunable_parts: str, lr: float = 2e-5,
                          projector_lr: Optional[float] = None,
                          vision_tower_lr: Optional[float] = None,
                          grad_accum: int = 1, accum_dtype=None,
                          **kw) -> Optimizer:
    """mm_tunable_parts (step.py:320-356): a comma list over
    {mm_mlp_adapter, mm_vision_tower, mm_language_model}; the projector and
    image_newline train with the first, the tower with the second, the
    LM with the third, and a part left out is frozen."""
    parts = set(tunable_parts.split(","))
    unknown = parts - {"mm_mlp_adapter", "mm_vision_tower",
                       "mm_language_model"}
    if unknown:
        raise ValueError(f"unknown tunable parts {sorted(unknown)}")
    adamw = _adamw_builder(**kw)
    groups = {}
    if "mm_language_model" in parts:
        groups["base"] = adamw(lr)
    if "mm_mlp_adapter" in parts:
        groups["projector"] = adamw(projector_lr or lr)
    if "mm_vision_tower" in parts:
        groups["vision_tower"] = adamw(vision_tower_lr or lr)

    def label(name):
        top = name.split(".")[0]
        if top in ("projector", "image_newline"):
            return "projector" if "projector" in groups else "frozen"
        if top == "siglip":
            return "vision_tower" if "vision_tower" in groups else "frozen"
        return "base" if "base" in groups else "frozen"

    return Optimizer(label, groups, grad_accum, accum_dtype)


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """The compute model, the masters of its trainable parameters (by
    state-dict name) and the optimizer state.  With compute_dtype None the
    masters ARE the model's parameters."""

    model: torch.nn.Module
    masters: dict
    opt_state: dict
    compute_dtype: Optional[torch.dtype] = None

    def load_masters(self) -> None:
        """Copy the masters into the compute model (a no-op when they are
        its own parameters)."""
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for n, m in self.masters.items():
                p = params[n]
                if p.data_ptr() != m.data_ptr():
                    p.copy_(m)


def init_train_state(model: torch.nn.Module, optimizer: Optimizer,
                     compute_dtype: Optional[torch.dtype] = None,
                     masters: Optional[dict] = None) -> TrainState:
    """Freeze what the optimizer does not train (requires_grad=False) and
    build the state.  compute_dtype None: the masters are the model's own
    parameters.  compute_dtype bf16 (the mixed policy): the masters are f32
    copies of the trainable parameters, taken before the model is cast to
    bf16 in place, or `masters` as given (a state dict by name, e.g. the
    JAX package's f32 tree through convert.masters_from_jax)."""
    params = dict(model.named_parameters())
    names = [n for n in params if optimizer.trainable(n)]
    for n, p in params.items():
        p.requires_grad_(n in names)
    if compute_dtype is None:
        if masters is not None:
            raise ValueError("given masters need a compute_dtype")
        masters = {n: params[n].data for n in names}
    else:
        given = masters
        masters = {}
        for n in names:
            src = params[n] if given is None else given[n]
            masters[n] = src.detach().to(device=params[n].device,
                                         dtype=torch.float32, copy=True)
        with torch.no_grad():
            for p in params.values():
                if p.is_floating_point():
                    p.data = p.data.to(compute_dtype)
    return TrainState(model, masters, optimizer.init(masters), compute_dtype)


def _no_sharding(mesh, batch_axes) -> None:
    if mesh is not None or batch_axes is not None:
        raise NotImplementedError("sharded training (mesh, batch_axes) is "
                                  "not ported")


def _microstep(state: TrainState, optimizer: Optimizer, forward) -> dict:
    """forward() -> (loss, metrics); backward, grad_norm over every leaf,
    one optimizer microstep on the masters.  The frozen leaves require a
    gradient for this forward and backward only: their gradients enter the
    norm and are freed."""
    params = dict(state.model.named_parameters())
    frozen = [p for n, p in params.items() if n not in state.masters
              and p.is_floating_point() and not p.requires_grad]
    for p in frozen:
        p.requires_grad_(True)
    try:
        loss, metrics = forward()
        loss.backward()
    finally:
        for p in frozen:
            p.requires_grad_(False)
    grads = {}
    for n in state.masters:
        p = params[n]
        grads[n] = (p.grad if p.grad is not None
                    else torch.zeros_like(p))
        p.grad = None
    sq = sum((g.float().square().sum() for g in grads.values()),
             torch.zeros((), device=loss.device))
    frozen_grads = [p.grad for p in frozen if p.grad is not None]
    if frozen_grads:
        # one fused pass, f32 sums of the bf16 gradients (no f32 copies)
        norms = torch._foreach_norm(frozen_grads, 2, dtype=torch.float32)
        sq = sq + torch.stack(norms).square().sum()
    del frozen_grads    # the gradients go with their last references
    for p in frozen:
        p.grad = None
    metrics["grad_norm"] = torch.sqrt(sq)
    optimizer.step(grads, state.opt_state, state.masters)
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg, optimizer: Optimizer, *, prefix_lm: bool = True,
                    policy: str = "uniform",
                    policy_args: Optional[dict] = None, remat=True,
                    use_flash: bool = False, attention_impl: str = "dense",
                    mesh=None, batch_axes=None, ce_chunk=None):
    """The LM-only step (step.py:195-250): train_step(state, batch,
    generator, masked_indices=None) -> metrics with batch =
    {"inputs_embeds" [B, L, D] (cast to the compute dtype), "labels"
    [B, L]}; the state's model is a LaViDa or a bare LLaDA."""
    _no_sharding(mesh, batch_axes)

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   masked_indices: Optional[torch.Tensor] = None) -> dict:
        state.load_masters()
        model = state.model
        lm = getattr(model, "llada", model)
        embeds = batch["inputs_embeds"].to(lm.wte.weight.dtype)
        return _microstep(state, optimizer, lambda: diffusion_loss(
            lm, embeds, batch["labels"], generator, prefix_lm=prefix_lm,
            policy=policy, policy_args=policy_args,
            masked_indices=masked_indices, remat=remat, use_flash=use_flash,
            attention_impl=attention_impl, ce_chunk=ce_chunk))

    return train_step


def make_multimodal_train_step(cfg, optimizer: Optimizer, *,
                               prefix_lm: bool = True,
                               policy: str = "uniform",
                               policy_args: Optional[dict] = None,
                               fim_id: Optional[int] = None, remat=True,
                               use_flash: bool = False,
                               attention_impl: str = "dense", mesh=None,
                               batch_axes=None, ce_chunk=None):
    """The end-to-end step (step.py:257-317): pixels -> SigLIP -> projector
    -> pool -> gather splice -> diffusion loss -> backward -> one optimizer
    microstep.  Returns train_step(state, batch, generator,
    masked_indices=None) -> metrics {loss, acc_mask, num_supervised,
    grad_norm} (0-d tensors), the state updated in place.  `batch` =
    {"pixel_values" [N, C, S, S], "text_ids" [B, T_text] and "gather_idx"
    [B, T] (host plans from multimodal.build_gather_plan), "labels"
    [B, T]}; `generator` draws the diffusion mask (on the model's device),
    `masked_indices` [B, T] bool replaces it (test injection).  `remat`
    reaches the LM blocks and the tower's layers.  The mixed-precision
    policy (the JAX step's `compute_dtype`) is the state's
    (`init_train_state`)."""
    _no_sharding(mesh, batch_axes)

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   masked_indices: Optional[torch.Tensor] = None) -> dict:
        state.load_masters()
        model = state.model
        pix = torch.as_tensor(batch["pixel_values"]).to(model.device)

        def forward():
            embeds = multimodal_embeds(model, pix, batch["text_ids"],
                                       batch["gather_idx"], remat=remat)
            return diffusion_loss(
                model.llada, embeds, torch.as_tensor(batch["labels"]),
                generator, prefix_lm=prefix_lm, policy=policy,
                policy_args=policy_args, masked_indices=masked_indices,
                fim_id=fim_id, remat=remat, use_flash=use_flash,
                attention_impl=attention_impl, ce_chunk=ce_chunk)

        return _microstep(state, optimizer, forward)

    return train_step
