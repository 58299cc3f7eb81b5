"""CLIP vision tower and its S2 multi-scale wrapper, ported from
lavida_mod_tpu/models/clip.py (reference clip_encoder.py, which wraps HF
CLIPVisionModel).

  - the patch conv (no bias) as `patchify` plus one Linear, a CLS token,
    a learned position table over CLS + patches;
  - an optional pre-layernorm (clip.py:106-108; ImageBind's trunk has
    none, models/open_clip.py);
  - pre-LN layers whose MLP activation is quick-GELU for `hidden_act`
    "quick_gelu" and jax.nn.gelu(approximate=True) for every other value
    (clip.py:115-117), each in jax.nn's bf16 op order (ops/activations);
  - `select_layer` counts hidden states as HF does (-2: the output of the
    second-to-last layer, so L - 1 layers run) and `select_feature`
    "patch" drops the CLS row, "cls_patch" keeps it (clip.py:111-141).

Attention goes through `vision_attention` (the short-attention kernel on
CUDA, all images in one launch per layer; its plain version on the CPU),
looked up in this module at each call so a check can swap in the plain
version on the card.

`s2_forward` (clip.py:146-180) runs the tower at each scale: the input
[N, C, S_max, S_max] resized to the scale as jax.image.resize's antialiased
bilinear rule does it (`ops/pooling.resize`; F.interpolate follows another
rule), a scale k times the base cut into a chessboard of k x k base-size
crops (the crops of one image in row-major order), the crops' feature
grids laid back into one k g x k g grid and brought to the base grid by
the un-antialiased bilinear resize in f32 (`_bilinear_no_antialias`); the
scales' features are concatenated channel-wise, in f32 when a scale was
resized there, as JAX's concatenate promotes them.  `S2` is the module
form that `build_vision_tower` returns.

`convert_clip_state_dict` (clip.py:196) builds the module from a HF
CLIPVisionModel state dict (`vision_model.*` names); `port_name` is its
map of one name.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch
from torch import nn

from ..config import SigLIPConfig, as_port_config
from ..ops.activations import gelu_tanh
from ..ops.attention import vision_attention
from ..ops.linear import linear
from ..ops.pooling import _bilinear_no_antialias, resize
from .siglip import LayerNorm, patchify


def clip_vit_l_config(**kw) -> SigLIPConfig:
    """openai/clip-vit-large-patch14-336 geometry (the LLaVA default)."""
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


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (clip.py:80) in jax.nn's bf16 op order: the
    constant rounded to x's dtype first (JAX's weakly typed constant), the
    sigmoid as 1 / (1 + exp(-z)), each op rounded (XLA's expansion of
    lax.logistic; torch.sigmoid rounds once)."""
    z = torch.tensor(1.702, dtype=x.dtype, device=x.device) * x
    return x * (1.0 / (1.0 + torch.exp(-z)))


def activation(hidden_act: str):
    return quick_gelu if hidden_act == "quick_gelu" else gelu_tanh


def layers_run(n_layers: int, select_layer: int) -> int:
    """The layers that produce hidden_states[select_layer] (clip.py:111)."""
    return n_layers + select_layer + 1 if select_layer < 0 else select_layer


def select(x: torch.Tensor, select_feature: str) -> torch.Tensor:
    if select_feature == "patch":
        return x[:, 1:]
    if select_feature == "cls_patch":
        return x
    raise ValueError(select_feature)


class CLIPLayer(nn.Module):
    """One pre-LN block: LN -> MHA -> residual, LN -> MLP -> residual.
    `rope`, when given to forward, rotates q and k first (MLCD)."""

    def __init__(self, cfg: SigLIPConfig, device, dtype=None):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.act = activation(cfg.hidden_act)
        self.ln1 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.ln2 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.q_proj = nn.Linear(D, D, **kw)
        self.k_proj = nn.Linear(D, D, **kw)
        self.v_proj = nn.Linear(D, D, **kw)
        self.out_proj = nn.Linear(D, D, **kw)
        self.fc1 = nn.Linear(D, I, **kw)
        self.fc2 = nn.Linear(I, D, **kw)

    def forward(self, h: torch.Tensor, attention, rope=None) -> torch.Tensor:
        N, T, _ = h.shape
        nh, hd = self.cfg.num_attention_heads, self.cfg.head_dim
        z = self.ln1(h)
        q = linear(z, self.q_proj).view(N, T, nh, hd)
        k = linear(z, self.k_proj).view(N, T, nh, hd)
        if rope is not None:
            q, k = rope(q), rope(k)
        att = attention(q, k, linear(z, self.v_proj).view(N, T, nh, hd))
        h = h + linear(att.reshape(N, T, -1), self.out_proj)
        return h + linear(self.act(linear(self.ln2(h), self.fc1)), self.fc2)


class CLIP(nn.Module):
    """The CLIP ViT (also open_clip's ViT-H and ImageBind's trunk:
    models/open_clip.py).  `pre_ln=False` builds ImageBind's trunk."""

    select_layer = -2

    def __init__(self, cfg: SigLIPConfig, device, dtype=None,
                 pre_ln: bool = True):
        super().__init__()
        cfg = as_port_config(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        P, C, D = cfg.patch_size, cfg.num_channels, cfg.hidden_size
        self.class_embed = nn.Parameter(torch.zeros(D, **kw))
        self.patch_embed = nn.Linear(C * P * P, D, bias=False, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches + 1, D,
                                                  **kw))
        self.pre_ln = (LayerNorm(D, cfg.layer_norm_eps, **kw) if pre_ln
                       else None)
        self.layers = nn.ModuleList(CLIPLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "CLIP":
        """Seeded weights as clip.init_params draws them: every matrix and
        the class / position tables ~ N(0, 0.02), zero biases, norms at
        one."""
        init_tower(self, generator)
        return self

    def embed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Pixels (cast to the tower's dtype, llava_arch.py:700) -> [N,
        1 + patches, D]: CLS, then the patches, plus the position table."""
        x = patchify(pixel_values.to(self.patch_embed.weight.dtype),
                     self.cfg.patch_size)
        x = linear(x, self.patch_embed)
        cls = self.class_embed.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1)

    def forward(self, pixel_values: torch.Tensor,
                select_layer: Optional[int] = None,
                select_feature: str = "patch") -> torch.Tensor:
        """[N, C, H, W] -> hidden_states[select_layer] [N, T', D]."""
        if select_layer is None:
            select_layer = self.select_layer
        x = self.embed(pixel_values) + self.pos_embed[None]
        if self.pre_ln is not None:
            x = self.pre_ln(x)
        for layer in self.layers[:layers_run(len(self.layers),
                                             select_layer)]:
            x = layer(x, vision_attention)
        return select(x, select_feature)


def init_tower(module: nn.Module, generator: torch.Generator,
               std: float = 0.02, norm_types: tuple = (LayerNorm,)) -> None:
    """Every Linear weight and every parameter that is not a norm's or a
    bias ~ N(0, std), biases zero, the weights of `norm_types` modules
    one; drawn on the module's device by `generator`, in the order of
    named_parameters."""
    norms = {id(m.weight) for m in module.modules()
             if isinstance(m, norm_types)}
    for name, p in module.named_parameters():
        if id(p) in norms:
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)


def _resize_images(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, size, size] by jax.image.resize's bilinear
    rule (antialiased when it shrinks; clip.py:183-189)."""
    return resize(x, size, (2, 3))


def s2_forward(tower: CLIP, pixel_values: torch.Tensor,
               scales: Sequence[int] = (336, 672, 1008),
               **kw) -> torch.Tensor:
    """[N, C, S_max, S_max] -> [N, base tokens, D * len(scales)]
    (clip.py:146-180)."""
    base = min(scales)
    g = base // tower.cfg.patch_size
    N, C = pixel_values.shape[:2]
    outs = []
    for s in scales:
        k = s // base
        img = _resize_images(pixel_values, s)
        if k == 1:
            outs.append(tower(img, **kw))
            continue
        crops = img.reshape(N, C, k, base, k, base).permute(
            0, 2, 4, 1, 3, 5).reshape(N * k * k, C, base, base)
        f = tower(crops, **kw)                       # [N k k, g g, D]
        D = f.shape[-1]
        f = f.reshape(N, k, k, g, g, D).permute(0, 1, 3, 2, 4, 5).reshape(
            N, k * g, k * g, D)
        outs.append(_bilinear_no_antialias(f, g).reshape(N, g * g, D))
    dtype = outs[0].dtype
    for o in outs[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return torch.cat([o.to(dtype) for o in outs], dim=-1)


class S2(nn.Module):
    """The S2 wrapper as a module: `tower` run at `scales`."""

    def __init__(self, tower: CLIP, scales: Sequence[int] = (336, 672, 1008)):
        super().__init__()
        self.tower = tower
        self.scales = tuple(scales)
        self.cfg = tower.cfg

    def forward(self, pixel_values: torch.Tensor, **kw) -> torch.Tensor:
        return s2_forward(self.tower, pixel_values, self.scales, **kw)


_LAYER = re.compile(r"encoder\.layers\.(\d+)\.(.+)\.(weight|bias)")
_LAYER_NAMES = {
    "layer_norm1": "ln1", "layer_norm2": "ln2",
    "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj", "self_attn.out_proj": "out_proj",
    "mlp.fc1": "fc1", "mlp.fc2": "fc2",
}
_TOP = {"embeddings.class_embedding": "class_embed",
        "embeddings.patch_embedding.weight": "patch_embed.weight",
        "embeddings.position_embedding.weight": "pos_embed",
        "pre_layrnorm.weight": "pre_ln.weight",
        "pre_layrnorm.bias": "pre_ln.bias"}


def port_name(name: str, cfg: SigLIPConfig) -> Optional[str]:
    """A CLIPVisionModel name below "vision_model." -> the CLIP module's
    state-dict name, or None for a weight that clip.py's converter does
    not read (post_layernorm, position_ids, the layers past the tower)."""
    if name in _TOP:
        return _TOP[name]
    m = _LAYER.fullmatch(name)
    if m and m.group(2) in _LAYER_NAMES:
        if int(m.group(1)) >= cfg.num_hidden_layers:
            return None
        return f"layers.{m.group(1)}.{_LAYER_NAMES[m.group(2)]}." \
               f"{m.group(3)}"
    return None


def load_named(module: nn.Module, named: dict, what: str) -> None:
    """Copy {state-dict name: tensor} into `module` (each cast to its
    parameter's dtype and device); a parameter without a tensor raises,
    naming `what`."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(named))
    if missing:
        raise KeyError(f"missing {what} weight for {missing[:4]}")
    with torch.no_grad():
        for name, t in named.items():
            p = params[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{what} weight {name}: shape "
                                 f"{tuple(t.shape)}, the module's "
                                 f"{tuple(p.shape)}")
            p.copy_(t)


def convert_clip_state_dict(state: dict, cfg: SigLIPConfig,
                            dtype=torch.bfloat16,
                            prefix: str = "vision_model.",
                            device="cuda") -> CLIP:
    """A CLIPVisionModel state dict (tensors or numpy arrays, names with or
    without `prefix`) -> the CLIP module in `dtype` on `device`
    (clip.py:196-243)."""
    cfg = as_port_config(cfg)
    model = CLIP(cfg, device, dtype)
    named = {}
    for key, value in state.items():
        name = key[len(prefix):] if key.startswith(prefix) else key
        target = port_name(name, cfg)
        if target is None:
            continue
        t = torch.as_tensor(value)
        if target == "patch_embed.weight":
            t = t.reshape(cfg.hidden_size, -1)
        named[target] = t
    load_named(model, named, "clip")
    return model.eval()
