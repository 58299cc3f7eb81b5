"""Reference (HF) LLaDA checkpoint names -> the port's LLaDA state-dict
names, the counterpart of lavida_mod_tpu/models/llada_loader.py.

Reference naming (modeling_llada.py:1125-1159, 809-948), with or without
the HF wrapper's "model." prefix:
  transformer.wte.weight                       [E, D]
  transformer.ln_f.weight                      [D]
  transformer.ff_out.weight                    [E, D]   (absent when tied)
  transformer.blocks.<i>.attn_norm.weight      [D]
  transformer.blocks.<i>.ff_norm.weight        [D]
  transformer.blocks.<i>.{q,k}_norm.weight     [D], [kvD] (attention_layer_norm)
  llama block:  q_proj/k_proj/v_proj/attn_out/ff_proj/up_proj/ff_out .weight
  sequential:   att_proj/attn_out/ff_proj/ff_out .weight

The port's linears are [out, in] like the reference's, so every name maps
without a transpose: transformer.blocks.3.q_proj.weight ->
blocks.3.q_proj.weight.  A name that maps to nothing raises.  LLaDA
checkpoints carry no linear or norm biases (include_bias and the
"default" LayerNorm are not ported, llada.check_supported), so a bias in
one raises too; Qwen2's QKV bias comes with the Dream names
(models/dream.py).

`load_torch_checkpoint(path, cfg)` is the LM-only entry: the shards of
`path` straight into an `LLaDA` on the card (or where `device` says).
"""

from __future__ import annotations

import re

import torch

from ..config import LLaDAConfig, as_port_config
from .llada import _LINEARS, LLaDA

_NORMS = ("attn_norm", "ff_norm", "q_norm", "k_norm")
_BLOCK = re.compile(r"blocks\.(\d+)\.(\w+)\.(weight|bias)")


def port_name(name: str, cfg: LLaDAConfig) -> str:
    """`name` after "transformer." -> the LLaDA module's state-dict name."""
    if name in ("wte.weight", "ln_f.weight"):
        return name
    if name == "ff_out.weight" and not cfg.weight_tying:
        return name
    m = _BLOCK.fullmatch(name)
    if m is not None:
        i, mod, leaf = int(m.group(1)), m.group(2), m.group(3)
        known = mod in _LINEARS.get(cfg.block_type, ()) or mod in _NORMS
        if leaf == "bias" and known:
            raise ValueError(f"transformer.{name}: the port's LLaDA has no "
                             f"biases (include_bias is not ported)")
        if i < cfg.n_layers and known:
            return name
    raise ValueError(f"transformer.{name}: no LLaDA weight of the port's "
                     f"{cfg.block_type} layout with {cfg.n_layers} layers "
                     f"has this name")


def plan_put(plan: dict, name: str, key: str) -> None:
    """plan[name] = key, raising when another key already maps there
    (e.g. a name both with and without the "model." prefix)."""
    if name in plan:
        raise ValueError(f"checkpoint keys {plan[name]!r} and {key!r} both "
                         f"map to {name}")
    plan[name] = key


def lm_plan(state, cfg: LLaDAConfig, prefix: str = "") -> dict:
    """{LLaDA state-dict name: checkpoint key} for every key of `state`
    that starts with [model.]transformer.; `prefix` goes before each
    port name."""
    plan: dict = {}
    for key in state:
        k = key[len("model."):] if key.startswith("model.") else key
        if k.startswith("transformer."):
            plan_put(plan, prefix + port_name(k[len("transformer."):], cfg),
                     key)
    return plan


def load_torch_checkpoint(path: str, cfg: LLaDAConfig,
                          dtype: torch.dtype = torch.bfloat16,
                          device="cuda"):
    """The safetensors or torch-bin shards of `path` (an LM-only
    checkpoint) -> an `LLaDA` in `dtype` on `device`."""
    from .lavida import close_checkpoint, fill_module, load_state_shards

    cfg = as_port_config(cfg)
    state = load_state_shards(path)
    try:
        extra = [k for k in state
                 if not k.startswith(("transformer.", "model.transformer."))]
        if extra:
            raise ValueError(f"{path}: keys outside the LM, e.g. "
                             f"{extra[:3]}")
        model = LLaDA(cfg, "meta", dtype).to_empty(device=device)
        fill_module(model, state, lm_plan(state, cfg))
    finally:
        close_checkpoint(state)
    return model.eval()
