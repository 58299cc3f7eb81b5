"""LoRA adapters and the SHIRG Extra-LoRA training step: the port of
lavida_mod_tpu/train/lora.py.

The factors live on the linears themselves (ops/quant.attach_lora):
`lora_a` [in, r] and `lora_b` [r, out], trainable, and a 0-d `lora_scale`,
frozen, and every linear kind adds ((x @ A) @ B) * scale in its forward, so
LLaDA's and SigLIP's linears take them.  The projector, as JAX's, reads
each linear's kernel and bias only (models/projector.py): factors there
do not act.  B starts at zero, so an adapted model computes what its base
does.

Which linears.  The JAX functions match a regex against each linear's path
in the JAX params tree (`_iter_linears`: "llada/blocks/q_proj",
"siglip/layers/v_proj", "projector/layers/0", ...).  `lora_path` gives each
port linear that path, through the converter's name map (convert.py) run
backwards: a layer-stacked linear (LLaDA's blocks, SigLIP's layers) has
the path of its stacked JAX leaf, so the same regex picks the same set.
`split_lora_state` returns JAX's keys and shapes: the factors of a stacked
linear stacked [L, ...] over its layers, `lora_scale` [L].

The SHIRG recipe (shirg_lora_config.py:17-140): rank 64, alpha 128, both
projector linears and SigLIP's q / k / v in every layer, with `lora_scale`
0 outside blocks 0-5 for q and k and outside blocks 0-3 for v.  Those inert
factors get a zero gradient and do not act in the forward, but the
optimizer's decoupled weight decay has no mask (optax.adamw, step.py:90-95):
an inert `lora_a` shrinks by (1 - lr_t * wd) each update while an inert
`lora_b` stays exactly zero; the projector's factors fare the same.  The
port does as JAX does (ROADMAP Queue 3).

Draws.  `add_lora` draws A ~ N(0, 1) / r from a torch generator: the same
law as JAX's jax.random draws, not the same numbers; the tests carry JAX's
factors across with convert.py.
"""

from __future__ import annotations

import re
from typing import Iterator, Optional

import torch
from torch import nn

from ..ops.quant import (Int4Linear, Int8Linear, attach_lora, detach_lora,
                         has_lora)
from .step import Optimizer, _adamw_builder, _DataShard, _microstep

DEFAULT_TARGETS = r"(projector|q_proj|k_proj|v_proj|attn_out)"
_STACKED = (("llada.blocks.", "llada/blocks/"),
            ("siglip.layers.", "siglip/layers/"))
_LINEAR_KINDS = (nn.Linear, Int8Linear, Int4Linear)


def lora_path(name: str) -> str:
    """A port linear's module name -> the path of its JAX leaf:
    llada.blocks.3.q_proj -> llada/blocks/q_proj, projector.layers.1 ->
    projector/layers/1, llada.ff_out -> llada/ff_out."""
    for port, jax_prefix in _STACKED:
        if name.startswith(port):
            _, _, rest = name[len(port):].partition(".")
            return jax_prefix + rest.replace(".", "/")
    return name.replace(".", "/")


def _layer(name: str) -> Optional[int]:
    for port, _ in _STACKED:
        if name.startswith(port):
            return int(name[len(port):].split(".")[0])
    return None


def iter_linears(model: nn.Module) -> Iterator[tuple[str, nn.Module]]:
    """(module name, linear) over the model's own linears; the mixed
    layout's int8 prefill twins (not in the JAX params tree) are left
    out."""
    for name, m in model.named_modules():
        if isinstance(m, _LINEAR_KINDS) and ".prefill" not in name:
            yield name, m


def _device(m: nn.Module) -> torch.device:
    return next(iter(m.state_dict().values())).device


def add_lora(model: nn.Module, seed: int = 0, rank: int = 64,
             alpha: float = 128.0, target_re: str = DEFAULT_TARGETS,
             dtype=torch.float32) -> nn.Module:
    """Attach LoRA factors, in place, to every linear whose JAX path
    matches `target_re` (lora.py:35-62): A ~ N(0, 1) / rank from a
    generator seeded with `seed` on the model's device, B zero, scale
    alpha / rank.  Returns the model."""
    n = 0
    gen = None
    for name, m in iter_linears(model):
        if not re.search(target_re, lora_path(name)):
            continue
        dev = _device(m)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randn(m.in_features, rank, generator=gen, device=dev)
        attach_lora(m, (a * (1.0 / rank)).to(dtype),
                    torch.zeros(rank, m.out_features, dtype=dtype,
                                device=dev), alpha / rank)
        n += 1
    if n == 0:
        raise ValueError(f"no linear matched {target_re!r}")
    return model


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold each linear's factors into its float weight, in place
    (lora.py:65-80): W + (A @ B * scale)^T in f32, cast to W's dtype; a
    quantized linear with factors raises."""
    for name, m in iter_linears(model):
        if not has_lora(m):
            continue
        if not isinstance(m, nn.Linear):
            raise ValueError(f"{name}: merge into int8 weights not "
                             f"supported")
        delta = (m.lora_a.float() @ m.lora_b.float()) * m.lora_scale.float()
        m.weight.copy_((m.weight.float() + delta.t()).to(m.weight.dtype))
        detach_lora(m)
    return model


def split_lora_state(model: nn.Module) -> dict:
    """{JAX path: {"lora_a", "lora_b", "lora_scale"}} of every linear with
    factors (lora.py:83-91), a stacked linear's layers stacked [L, ...]
    (each layer must carry factors); copies, not views of the model."""
    groups: dict = {}
    for name, m in iter_linears(model):
        groups.setdefault(lora_path(name), []).append((name, m))
    out = {}
    for path, mods in groups.items():
        with_lora = [m for _, m in mods if has_lora(m)]
        if not with_lora:
            continue
        if len(with_lora) != len(mods):
            raise ValueError(f"{path}: LoRA on {len(with_lora)} of its "
                             f"{len(mods)} layers; JAX stacks all or none")
        leaves = {k: [getattr(m, k).detach() for m in with_lora]
                  for k in ("lora_a", "lora_b", "lora_scale")}
        stacked = _layer(mods[0][0]) is not None
        out[path] = {k: torch.stack(v) if stacked else v[0].clone()
                     for k, v in leaves.items()}
    return out


def load_lora_state(model: nn.Module, lora_state: dict) -> nn.Module:
    """Attach the factors of `lora_state` (split_lora_state's layout) to
    their linears, in place, on each linear's device (lora.py:94-99)."""
    by_path: dict = {}
    for name, m in iter_linears(model):
        by_path.setdefault(lora_path(name), []).append((name, m))
    for path, factors in lora_state.items():
        if path not in by_path:
            raise KeyError(f"no linear at {path}")
        for name, m in by_path[path]:
            i = _layer(name)
            dev = _device(m)
            a, b, s = (torch.as_tensor(factors[k]) for k in
                       ("lora_a", "lora_b", "lora_scale"))
            if i is not None:
                a, b, s = a[i], b[i], s[i]
            attach_lora(m, a.to(dev).clone(), b.to(dev).clone(),
                        s.to(dev).clone())
    return model


def lora_label(name: str) -> str:
    """The optimizer group of a parameter: "lora" for the A and B factors,
    "frozen" for every other leaf (lora_scale included)."""
    return "lora" if name.rsplit(".", 1)[-1] in ("lora_a", "lora_b") \
        else "frozen"


def make_lora_optimizer(lr: float = 1e-4, weight_decay: float = 0.0,
                        grad_clip: float = 1.0, warmup_steps: int = 0,
                        total_steps: int = 10000) -> Optimizer:
    """AdamW on the lora_a / lora_b factors only, everything else frozen
    (lora.py:102-132): the clip sees the lora group's norm alone."""
    adamw = _adamw_builder(weight_decay=weight_decay, grad_clip=grad_clip,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
    return Optimizer(lora_label, {"lora": adamw(lr)})


# the SHIRG LoRA recipe (shirg/shirg_lora_config.py:17-140, lora.py:135-139)
SHIRG_LORA_RANK = 64
SHIRG_LORA_ALPHA = 128.0
SHIRG_LORA_TARGETS = (
    r"(projector|siglip/layers/(q_proj|k_proj|v_proj|out_proj))")
SHIRG_QK_BLOCKS = 6     # q and k adapted in SigLIP blocks 0-5
SHIRG_V_BLOCKS = 4      # v in blocks 0-3


@torch.no_grad()
def add_shirg_lora(model: nn.Module, seed: int = 0,
                   rank: int = SHIRG_LORA_RANK,
                   alpha: float = SHIRG_LORA_ALPHA,
                   dtype=torch.float32) -> nn.Module:
    """The SHIRG Extra-LoRA footprint (lora.py:142-163): both projector
    linears and SigLIP's q / k / v in every layer, `lora_scale` zeroed
    outside blocks 0-5 (q, k) and 0-3 (v).  In place; returns the model."""
    add_lora(model, seed, rank=rank, alpha=alpha,
             target_re=r"(projector|siglip/layers/(q_proj|k_proj|v_proj))",
             dtype=dtype)
    for i, layer in enumerate(model.siglip.layers):
        for name, limit in (("q_proj", SHIRG_QK_BLOCKS),
                            ("k_proj", SHIRG_QK_BLOCKS),
                            ("v_proj", SHIRG_V_BLOCKS)):
            getattr(layer, name).lora_scale.mul_(float(i < limit))
    return model


def make_shirg_lora_train_step(cfg, optimizer: Optimizer, *,
                               prefix_lm: bool = True,
                               shirg_method: str = "full", remat=True,
                               mesh=None):
    """The SHIRG-LoRA step (lora.py:166-217): each sample's two 448^2 views
    -> `shirg_encode` (980 tokens; the tower without remat, kernel #1 in
    the model's dtype) ++ its text embeddings -> the diffusion loss (dense
    attention, `remat` on the LLaDA blocks) -> backward -> one microstep of
    `optimizer` (make_lora_optimizer's: the factors move, nothing else).
    Returns train_step(state, batch, generator=None, masked_indices=None,
    noise=None) -> metrics {loss, acc_mask, num_supervised, grad_norm},
    the state updated in place; `state` is train.step.init_train_state's
    (compute_dtype None: the harness trains in f32).  batch =
    {"pixel_values" [B, 2, C, S, S], "text_ids" [B, T_text], "labels"
    [B, 980 + T_text]} (-100 over the image and prompt).  `generator`
    draws the diffusion mask and the `random` method's scores;
    `masked_indices` [B, L] and `noise` [B, N] replace them (test
    injection).  grad_norm covers every leaf, the frozen 8 B included,
    each frozen gradient freed as it is taken (train/step.py).  `mesh`:
    the model is sharded on it and the loss takes this rank's rows over
    dp x fsdp (train/step.py's sharded step)."""
    from ..models.shirg import shirg_encode

    shard = _DataShard(mesh, None)

    def train_step(state, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   masked_indices: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> dict:
        state.load_masters()
        model = state.model
        pix = torch.as_tensor(batch["pixel_values"]).to(model.device)
        ids = torch.as_tensor(batch["text_ids"]).to(model.device)

        def forward():
            img = shirg_encode(model, pix, method=shirg_method,
                               generator=generator, noise=noise)
            text = model.llada.embed_tokens(ids)
            embeds = torch.cat([img.to(text.dtype), text], dim=1)
            return shard.loss(model.llada, embeds, batch["labels"],
                              generator, masked_indices, "uniform", None,
                              prefix_lm=prefix_lm, remat=remat)

        return _microstep(state, optimizer, forward, mesh)

    return train_step
