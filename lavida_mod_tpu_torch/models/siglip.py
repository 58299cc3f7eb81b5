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
Not ported: bicubic interpolation of the position table for other
resolutions (a token count that differs from the table raises), int8
towers and LoRA.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SigLIPConfig, as_port_config
from ..ops.attention import vision_attention
from ..ops.activations import gelu_tanh
from ..ops.norms import layer_norm
from ..ops.vit_mlp import fused_vit_mlp


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

    def forward(self, h: torch.Tensor, fused_mlp: bool = False
                ) -> torch.Tensor:
        N, T, D = h.shape
        nh, hd = self.cfg.num_attention_heads, self.cfg.head_dim
        z = self.ln1(h)
        att = vision_attention(self.q_proj(z).view(N, T, nh, hd),
                               self.k_proj(z).view(N, T, nh, hd),
                               self.v_proj(z).view(N, T, nh, hd))
        h = h + self.out_proj(att.reshape(N, T, D))
        if fused_mlp:
            return fused_vit_mlp(h, self.ln2.weight, self.ln2.bias,
                                 self.fc1.weight, self.fc1.bias,
                                 self.fc2.weight, self.fc2.bias,
                                 self.cfg.layer_norm_eps)
        z = gelu_tanh(self.fc1(self.ln2(h)))
        return h + self.fc2(z)


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

    def fused_mlp_ok(self) -> bool:
        """siglip.py:84-100: the fused MLP kernel takes a plain bf16 tower
        (fc1/fc2 with their biases, no quantized layout) whose width is
        lane-aligned (128 | D)."""
        return all(isinstance(fc, nn.Linear) and fc.bias is not None
                   and fc.weight.dtype == torch.bfloat16
                   for layer in self.layers for fc in (layer.fc1, layer.fc2)
                   ) and self.cfg.hidden_size % 128 == 0

    def forward(self, pixel_values: torch.Tensor, fused_mlp: bool = False,
                remat: bool = False) -> torch.Tensor:
        """[N, C, H, W] preprocessed pixels -> raw features [N, tokens, D]
        after the tower's layers.  Pixels are cast to the tower's dtype
        first (the reference's images.to(dtype), llava_arch.py:700): f32
        pixels must not promote a bf16 tower to f32.  `remat`: checkpoint
        each layer when autograd records."""
        x = pixel_values.to(self.patch_embed.weight.dtype)
        x = self.patch_embed(patchify(x, self.cfg.patch_size))
        if x.shape[1] != self.pos_embed.shape[0]:
            raise NotImplementedError(
                f"{x.shape[1]} patch tokens vs a {self.pos_embed.shape[0]}-"
                f"slot position table: bicubic interpolation is not ported")
        x = x + self.pos_embed[None]
        remat = remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, fused_mlp, use_reentrant=False)
            else:
                x = layer(x, fused_mlp)
        return x
