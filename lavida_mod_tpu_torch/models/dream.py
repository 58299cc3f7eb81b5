"""Dream: the Qwen2-style bidirectional diffusion LM, the port of
lavida_mod_tpu/models/dream.py.

Dream is the LLaDA core in another geometry (llama-layout blocks with a
bias on q/k/v, GQA, RMSNorm, half-rotation RoPE, an untied head), so the
port runs it as `models.llada.LLaDA` with `dream_7b_config` and keeps here
only what differs: the token ids (configuration_dream.py:49-50), the tiny
test geometry, and the map from the reference's HF names
(modeling_dream.py) onto the LLaDA module's state-dict names, the
counterpart of `convert_dream_state_dict` (dream.py:88-132).  The port's
linears are [out, in] like the reference's, so no weight is transposed.

  model.embed_tokens.weight                     -> wte.weight
  model.norm.weight                             -> ln_f.weight
  lm_head.weight                                -> ff_out.weight
  model.layers.<i>.self_attn.{q,k,v}_proj.{weight,bias}
                                                -> blocks.<i>.{q,k,v}_proj.*
  model.layers.<i>.self_attn.o_proj.weight      -> blocks.<i>.attn_out.weight
  model.layers.<i>.mlp.{gate,up,down}_proj.weight
                                                -> blocks.<i>.{ff_proj,up_proj,ff_out}.weight
  model.layers.<i>.{input,post_attention}_layernorm.weight
                                                -> blocks.<i>.{attn,ff}_norm.weight

The model-internal names are taken with or without the "model." prefix, as
the JAX converter tries both; a name that maps nowhere raises.  The
differences from LLaDA in sampling live in generation/dream_sampler.py.
"""

from __future__ import annotations

import re

from ..config import LLaDAConfig, dream_7b_config

__all__ = ["DREAM_MASK_ID", "DREAM_PAD_ID", "DREAM_EOS_ID",
           "dream_7b_config", "tiny_dream_config", "port_name", "lm_plan",
           "QKV_BIASES"]

# token ids: configuration_dream.py:49-50, conversation stop 151643
DREAM_MASK_ID = 151666
DREAM_PAD_ID = 151643
DREAM_EOS_ID = 151643


def tiny_dream_config(**kw) -> LLaDAConfig:
    """dream.py:59-69: a two-layer Dream with GQA and the QKV bias."""
    base = dict(
        d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        mlp_hidden_size=128, rope_theta=10000.0, rms_norm_eps=1e-6,
        include_qkv_bias=True, vocab_size=512, embedding_size=512,
        weight_tying=False, max_sequence_length=512,
        block_type="llama", layer_norm_type="rms",
        mask_token_id=500, eos_token_id=501, pad_token_id=501,
    )
    base.update(kw)
    return LLaDAConfig(**base)


# reference HF names (modeling_dream.py) -> the port's llama-block names
_LINEARS = {
    "self_attn.q_proj": "q_proj",
    "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj",
    "self_attn.o_proj": "attn_out",
    "mlp.gate_proj": "ff_proj",
    "mlp.up_proj": "up_proj",
    "mlp.down_proj": "ff_out",
}
_NORMS = {
    "input_layernorm": "attn_norm",
    "post_attention_layernorm": "ff_norm",
}
_LAYER = re.compile(r"layers\.(\d+)\.([\w.]+)\.(weight|bias)")
_TOP = {"embed_tokens.weight": "wte.weight", "norm.weight": "ln_f.weight"}
QKV_BIASES = ("q_proj", "k_proj", "v_proj")


def port_name(key: str, cfg: LLaDAConfig):
    """A checkpoint key -> the LLaDA module's state-dict name, or None when
    the key is not the LM's (the vision tower's, the projector's)."""
    if key == "lm_head.weight":
        return "ff_out.weight"
    k = key[len("model."):] if key.startswith("model.") else key
    if k in _TOP:
        return _TOP[k]
    m = _LAYER.fullmatch(k)
    if m is None:
        return None
    i, mod, leaf = int(m.group(1)), m.group(2), m.group(3)
    name = _LINEARS.get(mod) or _NORMS.get(mod)
    if name is None or i >= cfg.n_layers:
        raise ValueError(f"{key}: no Dream weight of the port's "
                         f"{cfg.n_layers}-layer model has this name")
    if leaf == "bias" and not (name in QKV_BIASES and cfg.include_qkv_bias):
        raise ValueError(f"{key}: the port's Dream has biases on q/k/v "
                         f"only (include_qkv_bias)")
    return f"blocks.{i}.{name}.{leaf}"


def lm_plan(state, cfg: LLaDAConfig, prefix: str = "") -> dict:
    """{LLaDA state-dict name: checkpoint key} for every key of `state`
    that names a Dream LM weight; `prefix` goes before each port name."""
    from .llada_loader import plan_put

    plan: dict = {}
    for key in state:
        name = port_name(key, cfg)
        if name is not None:
            plan_put(plan, prefix + name, key)
    return plan

