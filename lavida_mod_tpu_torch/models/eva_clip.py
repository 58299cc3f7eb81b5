"""EVA-CLIP vision tower, ported from lavida_mod_tpu/models/eva_clip.py
(reference eva_clip/eva_vit.py:501-856; EVAVisionTransformer's inference
path as EVAEncoderWrapper runs it).

  - the patch conv (with bias) as `patchify` plus one Linear, a CLS token
    prepended, a learned position table;
  - blocks: a fused qkv without bias, or with `subln` separate q / k / v
    and an `inner_ln` on the attention output; `qkv_bias` adds q and v
    biases (K has none, eva_vit.py:260-266); pre-norm residuals, or with
    `postnorm` the norm applied to each branch's output before its
    layer-scale gamma (`ls_init_value`, eva_vit.py:428-446);
  - `rope`: the 2D interleaved rotary embedding of VisionRotaryEmbeddingFast
    (per-axis frequencies over half the head dim, broadcast-concatenated
    over the (h, w) grid, pairs rotated as (-x2, x1)) on every token but
    CLS (eva_clip.py:89-118, :238-247), its tables cast to the tower's
    dtype as JAX casts them;
  - FFN: an exact-GELU MLP, or `naiveswiglu` silu(w1) * w2, an `ffn_ln`
    under `subln`, then w3 (eva_vit.py:217-240);
  - the output of return_all_features: the LAST block skipped (`n_layers`
    defaults to layers - 1, eva_clip.py:221), no final norm, CLS dropped.

Its layer norm is not ops/norms.py's: the statistics AND the affine in
f32, one rounding to the input's dtype at the end (`_ln`, eva_clip.py:
173-179).  Attention goes through this module's `vision_attention`.

`convert_eva_state_dict` (:286) reads a torch EVAVisionTransformer state
dict.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import EVAConfig, as_port_config
from ..ops.activations import gelu_erf, silu
from ..ops.attention import vision_attention
from ..ops.linear import linear
from .clip import init_tower, load_named
from .siglip import patchify


def eva_clip_8b_config() -> EVAConfig:
    """EVA-CLIP-8B.json, the flagship config shipped with the reference."""
    return EVAConfig(image_size=224, patch_size=14, width=4096, layers=32,
                     head_width=128, mlp_ratio=5.0, qkv_bias=False)


def tiny_eva_config(**kw) -> EVAConfig:
    base = dict(image_size=56, patch_size=14, width=64, layers=3,
                head_width=16, mlp_ratio=2.0, qkv_bias=True)
    base.update(kw)
    return EVAConfig(**base)


def _vision_rope_tables(cfg: EVAConfig) -> tuple[np.ndarray, np.ndarray]:
    """cos / sin [grid*grid, head_width] in float64 (eva_vit.py:37-86)."""
    dim = cfg.head_width // 2
    ft = cfg.grid
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2)[: dim // 2]
                                      / dim))
    t = np.arange(ft) / ft * cfg.pt_hw_seq_len
    f = np.repeat(np.einsum("i,j->ij", t, freqs), 2, axis=-1)   # [ft, dim]
    fh = np.broadcast_to(f[:, None, :], (ft, ft, dim))
    fw = np.broadcast_to(f[None, :, :], (ft, ft, dim))
    full = np.concatenate([fh, fw], axis=-1).reshape(ft * ft, dim * 2)
    return np.cos(full), np.sin(full)


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)


class EVALayerNorm(nn.Module):
    """eva_clip.py's `_ln`: statistics and affine in f32."""

    def __init__(self, dim: int, eps: float, device, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class EVALayer(nn.Module):
    def __init__(self, cfg: EVAConfig, device, dtype=None):
        super().__init__()
        D, H, eps = cfg.width, cfg.mlp_hidden, cfg.layer_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.norm1 = EVALayerNorm(D, eps, **kw)
        self.norm2 = EVALayerNorm(D, eps, **kw)
        self.proj = nn.Linear(D, D, **kw)
        if cfg.subln:
            self.q_proj = nn.Linear(D, D, bias=False, **kw)
            self.k_proj = nn.Linear(D, D, bias=False, **kw)
            self.v_proj = nn.Linear(D, D, bias=False, **kw)
            self.inner_ln = EVALayerNorm(D, eps, **kw)
        else:
            self.qkv = nn.Linear(D, 3 * D, bias=False, **kw)
        if cfg.qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(D, **kw))
            self.v_bias = nn.Parameter(torch.zeros(D, **kw))
        if cfg.naiveswiglu:
            self.w1 = nn.Linear(D, H, **kw)
            self.w2 = nn.Linear(D, H, **kw)
            self.w3 = nn.Linear(H, D, **kw)
            if cfg.subln:
                self.ffn_ln = EVALayerNorm(H, eps, **kw)
        else:
            self.fc1 = nn.Linear(D, H, **kw)
            self.fc2 = nn.Linear(H, D, **kw)
        if cfg.ls_init_value:
            self.gamma_1 = nn.Parameter(torch.zeros(D, **kw))
            self.gamma_2 = nn.Parameter(torch.zeros(D, **kw))

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        cfg = self.cfg
        N, T, D = x.shape
        nh, hd = cfg.n_heads, cfg.head_width
        h = x if cfg.postnorm else self.norm1(x)
        if cfg.subln:
            q, k, v = (linear(h, m) for m in (self.q_proj, self.k_proj,
                                              self.v_proj))
        else:
            q, k, v = linear(h, self.qkv).chunk(3, dim=-1)
        if cfg.qkv_bias:
            q = q + self.q_bias
            v = v + self.v_bias
        # the kernel takes contiguous operands; the fused qkv's thirds are
        # strided views
        q, k, v = (t.reshape(N, T, nh, hd).contiguous() for t in (q, k, v))
        if rope is not None:
            q, k = rope(q).to(v.dtype), rope(k).to(v.dtype)
        att = vision_attention(q, k, v).reshape(N, T, D)
        if cfg.subln:
            att = self.inner_ln(att)
        att = linear(att, self.proj)
        if cfg.postnorm:
            att = self.norm1(att)
        if cfg.ls_init_value:
            att = att * self.gamma_1
        x = x + att

        h = x if cfg.postnorm else self.norm2(x)
        if cfg.naiveswiglu:
            hid = silu(linear(h, self.w1)) * linear(h, self.w2)
            if cfg.subln:
                hid = self.ffn_ln(hid)
            ff = linear(hid, self.w3)
        else:
            ff = linear(gelu_erf(linear(h, self.fc1)), self.fc2)
        if cfg.postnorm:
            ff = self.norm2(ff)
        if cfg.ls_init_value:
            ff = ff * self.gamma_2
        return x + ff


class EVAVisionTransformer(nn.Module):
    def __init__(self, cfg: EVAConfig, device, dtype=None):
        super().__init__()
        cfg = as_port_config(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        D = cfg.width
        self.patch_embed = nn.Linear(3 * cfg.patch_size ** 2, D, **kw)
        self.cls_token = nn.Parameter(torch.zeros(D, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.grid ** 2 + 1, D,
                                                  **kw))
        self.layers = nn.ModuleList(EVALayer(cfg, device, dtype)
                                    for _ in range(cfg.layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator
                         ) -> "EVAVisionTransformer":
        """Seeded weights as eva_clip.init_params draws them: N(0, 0.02)
        matrices and tables, zero biases (q_bias / v_bias too), norms at
        one, the layer-scale gammas at ls_init_value."""
        init_tower(self, generator, norm_types=(EVALayerNorm,))
        for layer in self.layers:
            if self.cfg.ls_init_value:
                layer.gamma_1.fill_(self.cfg.ls_init_value)
                layer.gamma_2.fill_(self.cfg.ls_init_value)
        return self

    def forward(self, pixel_values: torch.Tensor,
                n_layers: Optional[int] = None) -> torch.Tensor:
        """[N, C, S, S] -> [N, grid*grid, width] (eva_clip.py:197-279)."""
        cfg = self.cfg
        x = patchify(pixel_values.to(self.patch_embed.weight.dtype),
                     cfg.patch_size)
        x = linear(x, self.patch_embed)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed[None].to(x.dtype)
        rope = None
        if cfg.rope:
            c, s = (torch.from_numpy(a).to(device=x.device, dtype=x.dtype)
                    [None, :, None, :] for a in _vision_rope_tables(cfg))

            def rope(t):     # every token but CLS (eva_vit.py:330-339)
                p = t[:, 1:]
                return torch.cat([t[:, :1], p * c
                                  + _rotate_half_interleaved(p) * s], dim=1)

        n_run = cfg.layers - 1 if n_layers is None else n_layers
        for layer in self.layers[:n_run]:
            x = layer(x, rope)
        return x[:, 1:]


_TOP = {"patch_embed.proj.weight": "patch_embed.weight",
        "patch_embed.proj.bias": "patch_embed.bias",
        "cls_token": "cls_token", "pos_embed": "pos_embed"}
_LAYER_NAMES = {"norm1": "norm1", "norm2": "norm2", "attn.proj": "proj",
                "attn.q_proj": "q_proj", "attn.k_proj": "k_proj",
                "attn.v_proj": "v_proj", "attn.inner_attn_ln": "inner_ln",
                "attn.qkv": "qkv", "mlp.w1": "w1", "mlp.w2": "w2",
                "mlp.w3": "w3", "mlp.ffn_ln": "ffn_ln", "mlp.fc1": "fc1",
                "mlp.fc2": "fc2"}


def convert_eva_state_dict(state: dict, cfg: EVAConfig,
                           dtype=torch.float32, prefix: str = "",
                           device="cuda") -> EVAVisionTransformer:
    """A torch EVAVisionTransformer state dict (names with or without
    `prefix`) -> the module (eva_clip.py:286-352).  Every weight the
    config's branches read must be there; a layer's gammas are read when
    present (the config's ls_init_value decides whether they act)."""
    cfg = as_port_config(cfg)
    model = EVAVisionTransformer(cfg, device, dtype)

    def get(name):
        for cand in (prefix + name, name):
            if cand in state:
                return torch.as_tensor(np.asarray(state[cand]))
        return None

    named = {}
    for src, dst in _TOP.items():
        named[dst] = get(src)
    if named["patch_embed.weight"] is not None:
        named["patch_embed.weight"] = named["patch_embed.weight"].reshape(
            cfg.width, -1)
    if named["cls_token"] is not None:
        named["cls_token"] = named["cls_token"].reshape(-1)
    if named["pos_embed"] is not None:
        named["pos_embed"] = named["pos_embed"][0]
    params = dict(model.named_parameters())
    for i in range(cfg.layers):
        for src, dst in _LAYER_NAMES.items():
            for leaf in ("weight", "bias"):
                name = f"layers.{i}.{dst}.{leaf}"
                if name in params:
                    named[name] = get(f"blocks.{i}.{src}.{leaf}")
        for leaf in ("q_bias", "v_bias", "gamma_1", "gamma_2"):
            if f"layers.{i}.{leaf}" in params:
                named[f"layers.{i}.{leaf}"] = get(f"blocks.{i}.attn.{leaf}"
                                                  if "bias" in leaf else
                                                  f"blocks.{i}.{leaf}")
    missing = sorted(k for k, v in named.items() if v is None)
    if missing:
        raise KeyError(f"missing EVA weight for {missing[:4]}")
    load_named(model, named, "EVA")
    return model.eval()
