"""MLCD vision tower: the CLIP ViT with 2D rotary position embeddings,
ported from lavida_mod_tpu/models/mlcd.py (reference mlcd_encoder.py:1-179,
mlcd/vit_rope2d_hf.py:1-451).

The CLIP structure (CLS token, pre-layernorm, LN1 / attention / LN2 / MLP
residual blocks) with the position table replaced by rotary embeddings on
q and k:

  - each patch's (row, col) indexes a shared frequency table of head_dim/4
    per axis; the (h | w) concatenation is the head_dim/2 phase of the
    token (`rope_phase_table`, mlcd.py:63, built on the host in float64
    and cast to f32 as JAX builds it);
  - the CLS token carries a LEARNED phase vector (`class_pos_emb`
    [1, head_dim/2]);
  - the rotation is half-split (rotate_half), the phase duplicated over
    both halves, computed in f32 and cast back (`_apply_rope`, :77).

`select_layer` defaults to -2 and "patch" drops the CLS row (:95, :118,
mlcd_encoder.py:51-71).  Attention goes through this module's
`vision_attention`.  `convert_mlcd_state_dict` (:152) reads a HF
MLCDVisionModel state dict: the CLIP names plus `class_pos_emb`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import SigLIPConfig, as_port_config
from ..ops.attention import vision_attention
from .clip import CLIP, layers_run, load_named, port_name as clip_port_name
from .clip import select


def mlcd_vit_l_config(**kw) -> SigLIPConfig:
    """DeepGlint-AI/mlcd-vit-large-patch14-336 geometry."""
    base = dict(
        hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
        num_attention_heads=16, image_size=336, patch_size=14,
        layer_norm_eps=1e-5, hidden_act="quick_gelu",
        image_mean=(0.48145466, 0.4578275, 0.40821073),
        image_std=(0.26862954, 0.26130258, 0.27577711),
        drop_last_layer=False,
    )
    base.update(kw)
    return SigLIPConfig(**base)


def rope_phase_table(cfg: SigLIPConfig, grid_h: int, grid_w: int,
                     theta: float = 10000.0) -> np.ndarray:
    """[grid_h * grid_w, head_dim/2] f32 phases: (h | w) frequency halves
    per patch (vit_rope2d_hf.py:31-41, 290-307)."""
    d4 = cfg.head_dim // 4
    inv_freq = 1.0 / (theta ** (np.arange(0, d4, dtype=np.float64) * 2
                                / (2 * d4)))
    rows = np.repeat(np.arange(grid_h), grid_w).astype(np.float64)
    cols = np.tile(np.arange(grid_w), grid_h).astype(np.float64)
    return np.concatenate(
        [rows[:, None] * inv_freq[None], cols[:, None] * inv_freq[None]],
        axis=1).astype(np.float32)


def rope_cos_sin(phase: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """phase [T, hd/2] f32 -> cos, sin [1, T, 1, hd], each duplicated over
    both halves (computed once a forward; JAX's jit hoists them out of its
    layer scan)."""
    return (f(phase)[None, :, None, :].repeat(1, 1, 1, 2)
            for f in (torch.cos, torch.sin))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """x [N, T, H, hd]; cos, sin from `rope_cos_sin`.  Half-split rotation,
    in f32 (vit_rope2d_hf.py:19-29; mlcd.py:77)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


class MLCD(CLIP):
    """The MLCD tower: CLIP's parameters without the position table, and
    `class_pos_emb`."""

    def __init__(self, cfg: SigLIPConfig, device, dtype=None):
        super().__init__(cfg, device, dtype)
        del self.pos_embed
        self.class_pos_emb = nn.Parameter(torch.zeros(
            1, 2 * (self.cfg.head_dim // 4), device=device, dtype=dtype))

    def forward(self, pixel_values: torch.Tensor,
                select_layer: Optional[int] = None,
                select_feature: str = "patch") -> torch.Tensor:
        """[N, C, H, W] -> hidden_states[select_layer] (mlcd.py:90-150)."""
        if select_layer is None:
            select_layer = self.select_layer
        H, W = pixel_values.shape[2:]
        p = self.cfg.patch_size
        x = self.pre_ln(self.embed(pixel_values))
        patch_phase = torch.from_numpy(rope_phase_table(
            self.cfg, H // p, W // p)).to(x.device)
        cos, sin = rope_cos_sin(torch.cat([self.class_pos_emb.float(),
                                           patch_phase]))

        def rope(t):
            return _apply_rope(t, cos, sin)

        for layer in self.layers[:layers_run(len(self.layers),
                                             select_layer)]:
            x = layer(x, vision_attention, rope)
        return select(x, select_feature)


def convert_mlcd_state_dict(state: dict, cfg: SigLIPConfig,
                            dtype=torch.bfloat16,
                            prefix: str = "vision_model.",
                            device="cuda") -> MLCD:
    """A HF MLCDVisionModel state dict -> the MLCD module (the CLIP names
    plus class_pos_emb, no position table; mlcd.py:152-174)."""
    cfg = as_port_config(cfg)
    model = MLCD(cfg, device, dtype)
    named = {}
    for key, value in state.items():
        name = key[len(prefix):] if key.startswith(prefix) else key
        target = clip_port_name(name, cfg)
        if target is None or target == "pos_embed":
            continue
        t = torch.as_tensor(value)
        if target == "patch_embed.weight":
            t = t.reshape(cfg.hidden_size, -1)
        named[target] = t
    for cand in (prefix + "class_pos_emb", "class_pos_emb"):
        if cand in state:
            named["class_pos_emb"] = torch.as_tensor(state[cand])
            break
    else:
        raise KeyError("missing mlcd weight: class_pos_emb")
    load_named(model, named, "mlcd")
    return model.eval()
