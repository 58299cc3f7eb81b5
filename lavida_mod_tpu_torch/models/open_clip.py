"""open_clip and ImageBind vision towers, ported from
lavida_mod_tpu/models/open_clip.py (reference open_clip_encoder.py:1-163,
imagebind.py:1-73).

Both trunks are pre-norm CLIP-style ViTs, so the forward IS models/clip.py's
`CLIP` (open_clip.py:49); this module adds the two geometries and the
weight converters from each ecosystem's checkpoint layout:

  - open_clip visual (`convert_open_clip_visual`, :100): conv1, the class
    and position embeddings, ln_pre, and `transformer.resblocks.N.*`
    whose attention ships as ONE fused in_proj [3D, D] (torch
    nn.MultiheadAttention), split into q / k / v (`_split_in_proj`, :82);
  - imagebind vision (`convert_imagebind_vision`, :147): the rgbt stem is a
    Conv3d [D, C, 1, p, p] whose single time slice is the patch conv, the
    trunk `modality_trunks.vision.blocks.N.*`, and no ln_pre (the module
    has none).

`ImageBind` is the CLIP module without ln_pre whose `select_layer`
defaults to -1, the final trunk layer, with the CLS row dropped
(`imagebind_forward`, :204-211).  Its `hidden_act` "gelu" runs the tanh
GELU, as clip.py:115-117 runs every activation but quick_gelu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SigLIPConfig, as_port_config
from .clip import CLIP, load_named


def open_clip_vit_h14_378_config(**kw) -> SigLIPConfig:
    """ViT-H-14-378-quickgelu, the one geometry the reference registers
    (open_clip_encoder.py:14-16; 378 px, patch 14 -> a 27 x 27 grid)."""
    base = dict(
        hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
        num_attention_heads=16, image_size=378, patch_size=14,
        layer_norm_eps=1e-5, hidden_act="quick_gelu",
        image_mean=(0.48145466, 0.4578275, 0.40821073),
        image_std=(0.26862954, 0.26130258, 0.27577711),
        drop_last_layer=False,
    )
    base.update(kw)
    return SigLIPConfig(**base)


def imagebind_huge_vision_config(**kw) -> SigLIPConfig:
    """imagebind_huge's vision trunk (224 px ViT-H/14 -> 256 patches + CLS;
    gelu MLPs, no pre-layernorm)."""
    base = dict(
        hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
        num_attention_heads=16, image_size=224, patch_size=14,
        layer_norm_eps=1e-6, hidden_act="gelu",
        image_mean=(0.48145466, 0.4578275, 0.40821073),
        image_std=(0.26862954, 0.26130258, 0.27577711),
        drop_last_layer=False,
    )
    base.update(kw)
    return SigLIPConfig(**base)


class ImageBind(CLIP):
    """imagebind_huge's vision trunk: no ln_pre, the final layer's
    patch tokens by default."""

    select_layer = -1

    def __init__(self, cfg: SigLIPConfig, device, dtype=None):
        super().__init__(cfg, device, dtype, pre_ln=False)


def _split_in_proj(w: np.ndarray, b: np.ndarray, D: int):
    """A fused in_proj [3D, D] and its bias [3D] -> q, k, v as (weight
    [D, D], bias [D]) each in nn.Linear's [out, in] layout."""
    return [(w[i * D:(i + 1) * D], b[i * D:(i + 1) * D]) for i in range(3)]


def _convert(get, model: CLIP, top: dict, block: str, names: dict,
             what: str) -> CLIP:
    """`model` filled with `top` (its embeddings) and the per-layer weights
    of either trunk: `block` formats a layer's prefix, `names` maps its
    ln1 / ln2 / fc1 / fc2 / out_proj names."""
    D = model.cfg.hidden_size
    named = dict(top)
    for i in range(model.cfg.num_hidden_layers):
        lt = block.format(i)
        qkv = _split_in_proj(get(lt + "attn.in_proj_weight"),
                             get(lt + "attn.in_proj_bias"), D)
        for proj, (w, b) in zip(("q_proj", "k_proj", "v_proj"), qkv):
            named[f"layers.{i}.{proj}.weight"] = w
            named[f"layers.{i}.{proj}.bias"] = b
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                named[f"layers.{i}.{ours}.{leaf}"] = get(
                    f"{lt}{theirs}.{leaf}")
    load_named(model, {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in named.items()}, what)
    return model.eval()


def convert_open_clip_visual(state: dict, cfg: SigLIPConfig,
                             dtype=torch.bfloat16, prefix: str = "",
                             device="cuda") -> CLIP:
    """An open_clip `model.visual` state dict (names with `prefix`,
    "visual." or none) -> the CLIP module (open_clip.py:100-144)."""
    def get(name):
        for cand in (prefix + name, "visual." + name, name):
            if cand in state:
                return np.asarray(state[cand], np.float32)
        raise KeyError(f"missing open_clip weight: {prefix + name}")

    cfg = as_port_config(cfg)
    D = cfg.hidden_size
    top = {"class_embed": get("class_embedding"),
           "patch_embed.weight": get("conv1.weight").reshape(D, -1),
           "pos_embed": get("positional_embedding"),
           "pre_ln.weight": get("ln_pre.weight"),
           "pre_ln.bias": get("ln_pre.bias")}
    return _convert(get, CLIP(cfg, device, dtype), top,
                    "transformer.resblocks.{}.",
                    {"out_proj": "attn.out_proj", "fc1": "mlp.c_fc",
                     "fc2": "mlp.c_proj", "ln1": "ln_1", "ln2": "ln_2"},
                    "open_clip")


def convert_imagebind_vision(state: dict, cfg: SigLIPConfig,
                             dtype=torch.bfloat16,
                             device="cuda") -> ImageBind:
    """imagebind_huge's vision preprocessor and trunk -> the ImageBind
    module (open_clip.py:147-201)."""
    def get(name):
        if name in state:
            return np.asarray(state[name], np.float32)
        raise KeyError(f"missing imagebind weight: {name}")

    cfg = as_port_config(cfg)
    D = cfg.hidden_size
    conv = get("modality_preprocessors.vision.rgbt_stem.proj.weight")
    if conv.ndim == 5:                  # [D, C, T=1, p, p] -> [D, C, p, p]
        conv = conv[:, :, 0]
    pos = get("modality_preprocessors.vision.pos_embedding_helper.pos_embed")
    if pos.ndim == 3:                   # stored [1, T, D]
        pos = pos[0]
    top = {"class_embed": get("modality_preprocessors.vision.cls_token"
                              ).reshape(D),
           "patch_embed.weight": conv.reshape(D, -1),
           "pos_embed": pos}
    return _convert(get, ImageBind(cfg, device, dtype), top,
                    "modality_trunks.vision.blocks.{}.",
                    {"out_proj": "attn.out_proj", "fc1": "mlp.fc1",
                     "fc2": "mlp.fc2", "ln1": "norm_1", "ln2": "norm_2"},
                    "imagebind")
