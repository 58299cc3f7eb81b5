"""SigLIP ViT encoder, ported from lavida_mod_tpu/models/siglip.py
(reference siglip_base.py:110-627).

  - patch embedding: the conv with kernel = stride = patch is a block
    reshape (`patchify`) plus one Linear, whose [D, C*p*p] weight is the
    torch conv weight [D, C, p, p] flattened;
  - learned position embeddings, no CLS token;
  - pre-LN layers (LN -> MHA -> residual, LN -> tanh-GELU MLP -> residual);
  - the LaViDa tower drops the last encoder layer and reads the raw hidden
    state with no post-layernorm, so `cfg.n_layers_used` layers run.

Attention goes through `vision_attention`: the short-attention kernel on
CUDA (all views of an image in one launch per layer), its plain version on
the CPU.  With `fused_mlp` the MLP half of each layer runs as one
`fused_vit_mlp` call (kernel #9, ops/vit_mlp.py; siglip.py:194-207), which
`fused_mlp_ok` allows for a plain bf16 tower (siglip.py:84-100); it is a
serving choice, which the training step never makes.  The tower trains:
its ops are differentiable (the attention through the short-attention VJP)
and `remat` checkpoints each layer while autograd records (siglip.py:214-215).
Its linears take LoRA factors (ops/quant.attach_lora; SHIRG's Extra-LoRA on
q/k/v), and the fused MLP refuses an fc1 or fc2 that carries them or is
quantized (siglip.py:171-178).

A view whose patch grid differs from the position table's (SHIRG's 448^2
views: 32 x 32 patches against so400m's 27 x 27 table) gets the table
resized as `jax.image.resize(.., "bicubic")` resizes it (`_interp_pos_embed`,
siglip.py:103-110), which is not `F.interpolate(mode="bicubic")`: the Keys
kernel with a = -0.5 at half-pixel centres, taps outside the grid dropped
and each output's weights renormalised, and, for a smaller grid, the
kernel widened by the shrink factor (antialiasing).  `bicubic_weights`
builds that rule's [out, in] matrix on the host in numpy f32, and the table
is `W @ grid @ W^T` per channel in f32, cast back to the table's dtype.
The result is cached by grid size while the table does not change and no
gradient is wanted of it.

The int8 tower (`SigLIP.quantize_tower`, siglip.py:69-81): per-channel
int8 weights on every layer's q/k/v/out/fc1/fc2 (`Int8Linear`, per-(layer,
out) scales, the biases kept), the patch and position embeddings and the
norms in the float dtype.  Its linears run weight-only, or with
`act_int8` per-token int8 activations through the W8A8 kernel #3 (JAX's
`linear_act_int8`, siglip.py:160-178; the bias added in f32 before the
one rounding, as JAX's CPU path adds it).  `act_int8` on a float linear
is the plain linear, as in the JAX package, and `act_int8` with
`fused_mlp` raises, as JAX's assert does.

`port_name` maps the reference checkpoint's tower names (siglip_base.py:
576-627, below "vision_model.") onto this module's, as
`convert_siglip_state_dict` (siglip.py:228) reads them: the patch conv
[D, C, p, p] becomes `patch_embed.weight` [D, C*p*p] (`PATCH_CONV`), and
the layers past `n_layers_used` (the last one, which the tower deletes,
siglip_encoder.py:240), the post-layernorm and the pooling head, which
the LaViDa tower never runs, map to None: they are dropped.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SigLIPConfig, as_port_config
from ..ops.attention import vision_attention
from ..ops.activations import gelu_tanh
from ..ops.norms import layer_norm
from ..ops.pooling import resize_weights
from ..ops.vit_mlp import fused_vit_mlp
from ..ops.quant import Int8Linear, has_lora
from ..parallel.sharding import ParallelLinear, compute_weight


def bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 weights of jax.image.resize's bicubic rule along
    one axis (jax/_src/image/scale.py compute_weight_mat with scale
    n_out / n_in, no translation, antialias on)."""
    return resize_weights(n_in, n_out, "bicubic")


def interp_pos_embed(pos_embed: torch.Tensor, grid: int) -> torch.Tensor:
    """[g*g, D] table -> [grid*grid, D] by the bicubic rule, in f32, cast
    back to the table's dtype (siglip.py:103-110)."""
    g = int(round(math.sqrt(pos_embed.shape[0])))
    D = pos_embed.shape[-1]
    w = torch.from_numpy(bicubic_weights(g, grid)).to(pos_embed.device)
    t = pos_embed.reshape(g, g, D).float()
    out = torch.einsum("ai,ijd,bj->abd", w, t, w)
    return out.reshape(grid * grid, D).to(pos_embed.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def _plain_linear(m: nn.Module) -> bool:
    """A float nn.Linear without LoRA factors: plain, or a sharded one,
    whose whole weight the fused MLP gathers over fsdp and tp (as GSPMD
    hands the JAX kernel whole fc1 / fc2 weights)."""
    if type(m) is nn.Linear:
        return True
    return (type(m) is ParallelLinear and m.base_cls is nn.Linear
            and not has_lora(m))


class SigLIPLayer(nn.Module):
    def __init__(self, cfg: SigLIPConfig, device, dtype=None):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.ln2 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.q_proj = nn.Linear(D, D, **kw)
        self.k_proj = nn.Linear(D, D, **kw)
        self.v_proj = nn.Linear(D, D, **kw)
        self.out_proj = nn.Linear(D, D, **kw)
        self.fc1 = nn.Linear(D, I, **kw)
        self.fc2 = nn.Linear(I, D, **kw)

    def forward(self, h: torch.Tensor, fused_mlp: bool = False,
                act_int8: bool = False) -> torch.Tensor:
        N, T, _ = h.shape
        hd = self.cfg.head_dim

        def lin(m, x):
            return m(x, act_int8=act_int8) if isinstance(m, Int8Linear) \
                else m(x)

        z = self.ln1(h)
        # -1 heads: a tensor-parallel rank holds its own heads
        att = vision_attention(lin(self.q_proj, z).view(N, T, -1, hd),
                               lin(self.k_proj, z).view(N, T, -1, hd),
                               lin(self.v_proj, z).view(N, T, -1, hd))
        h = h + lin(self.out_proj, att.reshape(N, T, -1))
        if fused_mlp:
            if not all(_plain_linear(fc) for fc in (self.fc1, self.fc2)):
                raise ValueError("fused_mlp takes plain float fc1 / fc2 "
                                 "only: no LoRA factors, no int8 layout")
            return fused_vit_mlp(h, self.ln2.weight, self.ln2.bias,
                                 compute_weight(self.fc1.weight, whole=True),
                                 self.fc1.bias,
                                 compute_weight(self.fc2.weight, whole=True),
                                 self.fc2.bias, self.cfg.layer_norm_eps)
        z = gelu_tanh(lin(self.fc1, self.ln2(h)))
        return h + lin(self.fc2, z)


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, (H//p)*(W//p), C*p*p] in (c, ph, pw) minor order
    (the conv weight layout).  Trailing pixels past a whole patch are
    dropped, as the valid-padding conv drops them (384 = 27*14 + 6)."""
    N, C, H, W = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values[:, :, :gh * patch, :gw * patch]
    x = x.reshape(N, C, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(N, gh * gw, C * patch * patch)


class SigLIP(nn.Module):
    def __init__(self, cfg: SigLIPConfig, device, dtype=None):
        super().__init__()
        cfg = as_port_config(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        P, C, D = cfg.patch_size, cfg.num_channels, cfg.hidden_size
        self.patch_embed = nn.Linear(C * P * P, D, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches, D, **kw))
        self.layers = nn.ModuleList(
            SigLIPLayer(cfg, device, dtype) for _ in range(cfg.n_layers_used))
        self._pos_cache = (None, None)

    def fused_mlp_ok(self) -> bool:
        """siglip.py:84-100: the fused MLP kernel takes a plain bf16 tower
        (fc1/fc2 with their biases, no LoRA, no quantized layout) whose
        width is lane-aligned (128 | D)."""
        return all(_plain_linear(fc) and fc.bias is not None
                   and fc.weight.dtype == torch.bfloat16
                   for layer in self.layers for fc in (layer.fc1, layer.fc2)
                   ) and self.cfg.hidden_size % 128 == 0

    LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")

    @torch.no_grad()
    def quantize_tower(self) -> None:
        """siglip.py:69-81 in place: every layer's linears int8 per
        channel (`Int8Linear`, biases kept), each float weight freed as its
        twin exists; the embeddings and norms stay float."""
        for layer in self.layers:
            for n in self.LINEARS:
                setattr(layer, n, Int8Linear.from_linear(getattr(layer, n)))

    def adopt_int8(self) -> None:
        """The int8 tower's modules on "meta" (for load_state_dict(assign=
        True) of a state holding `.weight_q` / `.scale`)."""
        for layer in self.layers:
            for n in self.LINEARS:
                m = getattr(layer, n)
                setattr(layer, n, Int8Linear(m.in_features, m.out_features,
                                             "meta", bias=True))

    def forward(self, pixel_values: torch.Tensor, fused_mlp: bool = False,
                remat: bool = False, act_int8: bool = False) -> torch.Tensor:
        """[N, C, H, W] preprocessed pixels -> raw features [N, tokens, D]
        after the tower's layers.  Pixels are cast to the tower's dtype
        first (the reference's images.to(dtype), llava_arch.py:700): f32
        pixels must not promote a bf16 tower to f32.  `remat`: checkpoint
        each layer when autograd records.  `act_int8`: per-token int8
        activations on the int8 tower's linears (kernel #3 on the card)."""
        if act_int8 and fused_mlp:
            raise ValueError("fused_mlp supports plain bf16 fc1/fc2 only: "
                             "no act_int8 (siglip.py:174-178)")
        x = pixel_values.to(self.patch_embed.weight.dtype)
        # the patch embedding reads weight and bias only, as JAX's
        # (siglip.py:151-152)
        x = torch.nn.functional.linear(patchify(x, self.cfg.patch_size),
                                       self.patch_embed.weight,
                                       self.patch_embed.bias)
        x = x + self.pos_table(x.shape[1])[None]
        remat = remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, fused_mlp, act_int8,
                               use_reentrant=False)
            else:
                x = layer(x, fused_mlp, act_int8)
        return x

    def pos_table(self, n_tokens: int) -> torch.Tensor:
        """The position table for `n_tokens` patches: the learned one, or
        it resized bicubically to the square grid of n_tokens."""
        pos = self.pos_embed
        if n_tokens == pos.shape[0]:
            return pos
        grid = int(round(math.sqrt(n_tokens)))
        if grid * grid != n_tokens:
            raise ValueError(f"{n_tokens} patch tokens are no square grid")
        if torch.is_grad_enabled() and pos.requires_grad:
            return interp_pos_embed(pos, grid)
        key = (grid, pos.data_ptr(), pos._version, pos.dtype, pos.device)
        if self._pos_cache[0] != key:
            self._pos_cache = (key, interp_pos_embed(pos.detach(), grid))
        return self._pos_cache[1]


PATCH_CONV = "embeddings.patch_embedding.weight"
_LAYER = re.compile(r"encoder\.layers\.(\d+)\.(.+)")
_LAYER_NAMES = {
    "layer_norm1": "ln1", "layer_norm2": "ln2",
    "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj", "self_attn.out_proj": "out_proj",
    "mlp.fc1": "fc1", "mlp.fc2": "fc2",
}
_UNUSED = ("post_layernorm.", "head.")


def port_name(name: str, cfg: SigLIPConfig) -> Optional[str]:
    """`name` after "vision_model." -> the SigLIP module's state-dict name,
    or None for a weight the tower drops; raises for any other name."""
    top = {PATCH_CONV: "patch_embed.weight",
           "embeddings.patch_embedding.bias": "patch_embed.bias",
           "embeddings.position_embedding.weight": "pos_embed"}
    if name in top:
        return top[name]
    if name.startswith(_UNUSED):
        return None
    m = _LAYER.fullmatch(name)
    if m is not None:
        i, rest = int(m.group(1)), m.group(2)
        mod, _, leaf = rest.rpartition(".")
        if mod in _LAYER_NAMES and leaf in ("weight", "bias"):
            if i >= cfg.n_layers_used:
                return None
            return f"layers.{i}.{_LAYER_NAMES[mod]}.{leaf}"
    raise ValueError(f"vision_model.{name}: no SigLIP weight of the port "
                     f"has this name")
