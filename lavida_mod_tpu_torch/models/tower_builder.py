"""Vision-tower registry, ported from lavida_mod_tpu/models/tower_builder.py
(reference multimodal_encoder/builder.py:13-52).

`build_vision_tower(name, ...)` dispatches on the name in JAX's order
(tower_builder.py:36-73): "hf:" / "hf-" first (`hf_vision_tower`), then
"siglip" (LaViDa's tower), "mlcd", "open_clip", "imagebind" and "eva", and
only then "clip", which takes the S2 wrapper when `s2=True` or the name
holds "s2"; any other name raises ValueError.  It returns (config, module):
the module runs the tower (`module(pixel_values)`) with the default
feature selection of JAX's forward for that name, built on `device` in
`dtype` with weights drawn from `generator` as the JAX init_params draws
them (a generator seeded 0 when none is given; none on "meta").  Real
weights come from each module's converter (convert_clip_state_dict, ...)
or from convert.module_from_jax.

`hf_vision_tower` (:85-124) reads a checkpoint directory's config.json,
unwraps `vision_config`, maps `model_type` through `_HF_MODEL_TYPES`
(:76-82) and builds a geometry-matching config; an unsupported type raises
NotImplementedError, as JAX's does.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
from torch import nn

from ..config import SigLIPConfig
from . import clip, eva_clip, mlcd, open_clip
from .siglip import SigLIP


def _built(module: nn.Module, device, generator: Optional[torch.Generator]
           ) -> nn.Module:
    if torch.device(device).type != "meta":
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        if isinstance(module, SigLIP):
            with torch.no_grad():
                clip.init_tower(module, generator)
        else:
            module.reset_parameters(generator)
    return module.eval()


def build_vision_tower(name: str, device="cuda", dtype=torch.bfloat16,
                       generator: Optional[torch.Generator] = None,
                       **kw) -> tuple[object, nn.Module]:
    """(cfg, module) of the tower `name`; `cfg=` overrides the family's
    default geometry, `s2=True` wraps a CLIP tower in S2."""
    lname = name.lower()
    if lname.startswith("hf:") or lname.startswith("hf-"):
        return hf_vision_tower(name[3:], device=device, dtype=dtype,
                               generator=generator)
    cfg = kw.pop("cfg", None)
    if "siglip" in lname:
        cfg = cfg or SigLIPConfig()
        module = SigLIP(cfg, device, dtype)
    elif "mlcd" in lname:
        cfg = cfg or mlcd.mlcd_vit_l_config()
        module = mlcd.MLCD(cfg, device, dtype)
    elif "open_clip" in lname:
        cfg = cfg or open_clip.open_clip_vit_h14_378_config()
        module = clip.CLIP(cfg, device, dtype)
    elif "imagebind" in lname:
        cfg = cfg or open_clip.imagebind_huge_vision_config()
        module = open_clip.ImageBind(cfg, device, dtype)
    elif "eva" in lname:
        cfg = cfg or eva_clip.eva_clip_8b_config()
        module = eva_clip.EVAVisionTransformer(cfg, device, dtype)
    elif "clip" in lname:
        cfg = cfg or clip.clip_vit_l_config()
        module = clip.CLIP(cfg, device, dtype)
        if kw.pop("s2", False) or "s2" in lname:
            return cfg, clip.S2(_built(module, device, generator))
    else:
        raise ValueError(f"Unknown vision tower: {name}")
    return cfg, _built(module, device, generator)


_HF_MODEL_TYPES = {
    "clip_vision_model": "clip",
    "clip": "clip",
    "siglip_vision_model": "siglip",
    "siglip": "siglip",
    "mlcd_vision_model": "mlcd",
}


def hf_vision_tower(path_or_type: str, device="cuda", dtype=torch.bfloat16,
                    generator: Optional[torch.Generator] = None
                    ) -> tuple[object, nn.Module]:
    """A generic HF checkpoint's tower (reference hf_vision.py:1-111): a
    directory's config.json (its `vision_config` when nested) or a bare
    model_type -> the family's (cfg, module) with the checkpoint's
    geometry."""
    model_type = path_or_type
    hf_cfg: dict = {}
    if os.path.isdir(path_or_type):
        with open(os.path.join(path_or_type, "config.json")) as f:
            hf_cfg = json.load(f)
        if "vision_config" in hf_cfg:
            hf_cfg = hf_cfg["vision_config"]
        model_type = hf_cfg.get("model_type", "")
    family = _HF_MODEL_TYPES.get(model_type)
    if family is None:
        raise NotImplementedError(
            f"hf vision tower model_type {model_type!r} not supported "
            f"(supported: {sorted(set(_HF_MODEL_TYPES))})")
    geo = {k: hf_cfg[k]
           for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                     "num_attention_heads", "image_size", "patch_size",
                     "layer_norm_eps", "hidden_act")
           if k in hf_cfg}
    if family == "siglip":
        cfg = SigLIPConfig(**geo)
        module = SigLIP(cfg, device, dtype)
    elif family == "mlcd":
        cfg = mlcd.mlcd_vit_l_config(**geo)
        module = mlcd.MLCD(cfg, device, dtype)
    else:
        cfg = clip.clip_vit_l_config(**geo)
        module = clip.CLIP(cfg, device, dtype)
    return cfg, _built(module, device, generator)
