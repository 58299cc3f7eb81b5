"""AR baseline models (the legacy LLaVA families llava_llama, llava_qwen,
llava_mistral, llava_mixtral), the port of lavida_mod_tpu/models/
ar_models.py.

They are llama-layout transformers that the LLaDA module runs with
`causal=True` (models/llada.py; sampled by generation/ar_sampler.py), so
this module keeps only what differs: their geometries (ar_models.py:19-77,
each with `**kw` overrides), and the map from HF checkpoint names onto the
LLaDA module's state-dict names, which is Dream's (Qwen2) converter
(models/dream.py: `port_name`, `lm_plan`; the QKV bias where the config
has it).  Mixtral's experts come from `convert_mixtral_moe_layer`
(ar_models.py:80-102): `block_sparse_moe.gate` and `experts.N.{w1, w2,
w3}` (w1 the gate projection, w3 up, w2 down) become a block's `moe`
entry (models/moe.py), in the JAX orientation [in, out].  Unlike the JAX
package, `convert_ar_state_dict` takes those layers too (it hands them to
`convert_mixtral_moe_layer`), so a whole Mixtral state dict converts in one
call.

`ar_model(cfg, state)` builds the LLaDA module of a converted state dict on
the card (or where `device` says); `random_ar_model` draws one from a seed,
as the JAX `init_params` draws its weights.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from ..config import LLaDAConfig
from .dream import lm_plan

_MOE_KEY = re.compile(r"(?:model\.)?layers\.(\d+)\.block_sparse_moe\.")


def llama3_8b_config(**kw) -> LLaDAConfig:
    base = dict(
        d_model=4096, n_heads=32, n_kv_heads=8, n_layers=32,
        mlp_hidden_size=14336, block_type="llama", activation="silu",
        rope_theta=500000.0, layer_norm_type="rms", rms_norm_eps=1e-5,
        include_qkv_bias=False, vocab_size=128256, embedding_size=128256,
        weight_tying=False, max_sequence_length=8192,
        mask_token_id=128255, eos_token_id=128009, pad_token_id=128009,
    )
    base.update(kw)
    return LLaDAConfig(**base)


def qwen2_7b_config(**kw) -> LLaDAConfig:
    base = dict(
        d_model=3584, n_heads=28, n_kv_heads=4, n_layers=28,
        mlp_hidden_size=18944, block_type="llama", activation="silu",
        rope_theta=1000000.0, layer_norm_type="rms", rms_norm_eps=1e-6,
        include_qkv_bias=True, vocab_size=152064, embedding_size=152064,
        weight_tying=False, max_sequence_length=32768,
        mask_token_id=151666, eos_token_id=151645, pad_token_id=151643,
    )
    base.update(kw)
    return LLaDAConfig(**base)


def mistral_7b_config(**kw) -> LLaDAConfig:
    base = dict(
        d_model=4096, n_heads=32, n_kv_heads=8, n_layers=32,
        mlp_hidden_size=14336, block_type="llama", activation="silu",
        rope_theta=1000000.0, layer_norm_type="rms", rms_norm_eps=1e-5,
        include_qkv_bias=False, vocab_size=32768, embedding_size=32768,
        weight_tying=False, max_sequence_length=32768,
        mask_token_id=32767, eos_token_id=2, pad_token_id=2,
    )
    base.update(kw)
    return LLaDAConfig(**base)


def mixtral_8x7b_config(**kw) -> LLaDAConfig:
    """Mixtral-8x7B geometry; its blocks carry experts (models/moe.py:
    `ar_model` / `random_ar_model` with moe=(8, 14336))."""
    base = dict(
        d_model=4096, n_heads=32, n_kv_heads=8, n_layers=32,
        mlp_hidden_size=14336, block_type="llama", activation="silu",
        rope_theta=1000000.0, layer_norm_type="rms", rms_norm_eps=1e-5,
        include_qkv_bias=False, vocab_size=32000, embedding_size=32000,
        weight_tying=False, max_sequence_length=32768,
        mask_token_id=31999, eos_token_id=2, pad_token_id=2,
    )
    base.update(kw)
    return LLaDAConfig(**base)


def _torch(a, dtype) -> torch.Tensor:
    """A numpy array or tensor -> a CPU tensor in `dtype`."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", dtype)
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def convert_mixtral_moe_layer(state, layer_idx: int, n_experts: int = 8,
                              dtype=torch.bfloat16, prefix: str = "model."
                              ) -> dict[str, torch.Tensor]:
    """HF Mixtral names -> one layer's experts (ar_models.py:80-102):
    block_sparse_moe.gate.weight [E, D] and experts.N.{w1, w2, w3}.weight
    (numpy arrays or tensors) -> {"router" [D, E], "ff_proj" (w1) and
    "up_proj" (w3) [E, D, H], "ff_out" (w2) [E, H, D]} in `dtype`."""
    def get(name):
        for cand in (prefix + name, name):
            if cand in state:
                return _torch(state[cand], torch.float32)
        raise KeyError(name)

    lp = f"layers.{layer_idx}.block_sparse_moe."
    experts = {"ff_proj": "w1", "up_proj": "w3", "ff_out": "w2"}
    out = {"router": get(f"{lp}gate.weight").t()}
    for name, w in experts.items():
        out[name] = torch.stack([get(f"{lp}experts.{e}.{w}.weight").t()
                                 for e in range(n_experts)])
    return {k: v.to(dtype).contiguous() for k, v in out.items()}


def convert_ar_state_dict(state, cfg: LLaDAConfig, dtype=torch.bfloat16
                          ) -> dict[str, torch.Tensor]:
    """An HF Llama / Qwen2 / Mistral / Mixtral state dict (numpy arrays or
    tensors) -> the LLaDA module's state dict in `dtype`: Dream's names
    (`convert_dream_state_dict`, ar_models.py:16), and each layer's
    `block_sparse_moe` as `blocks.<i>.moe.*` (convert_mixtral_moe_layer)."""
    moe_layers = sorted({int(m.group(1)) for k in state
                         if (m := _MOE_KEY.match(k))})
    dense = {k: v for k, v in state.items() if not _MOE_KEY.match(k)}
    out = {name: _torch(dense[key], dtype)
           for name, key in lm_plan(dense, cfg).items()}
    for i in moe_layers:
        n_experts = len({k for k in state if re.search(
            rf"layers\.{i}\.block_sparse_moe\.experts\.\d+\.w1\.", k)})
        prefix = "model." if f"model.layers.{i}.block_sparse_moe.gate.weight" \
            in state else ""
        for name, t in convert_mixtral_moe_layer(
                state, i, n_experts, dtype, prefix).items():
            out[f"blocks.{i}.moe.{name}"] = t
    return out


def ar_model(cfg: LLaDAConfig, state: dict, device="cuda") -> "LLaDA":
    """The LLaDA module of a state dict in the module's names (e.g.
    `convert_ar_state_dict`'s), its experts sized from the state, its
    parameters in the state's dtypes, on `device`."""
    from .llada import LLaDA

    model = LLaDA(cfg, "meta")
    model.adopt_layout(state)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device).eval()


@torch.no_grad()
def random_ar_model(cfg: LLaDAConfig, seed: int, dtype=torch.bfloat16,
                    device="cuda", moe: Optional[tuple[int, int]] = None
                    ) -> "LLaDA":
    """A seeded LLaDA module drawn on `device` as the JAX `init_params`
    draws one (llada.py:47-105; moe.py:27-50): every linear, the
    embedding and the experts ~ N(0, 0.02), norms at one, QKV biases zero.
    moe: (n_experts, hidden) for the Mixtral layout."""
    from .llada import LLaDA, Norm

    model = LLaDA(cfg, "meta", dtype, moe=moe).to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Norm):
            m.weight.fill_(1.0)
        elif isinstance(m, (torch.nn.Linear, torch.nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=gen)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    for b in model.blocks:
        if b.moe is not None:
            for p in b.moe.parameters():
                p.normal_(0.0, 0.02, generator=gen)
    return model.eval()
