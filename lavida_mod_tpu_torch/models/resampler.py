"""Vision resamplers, ported from lavida_mod_tpu/models/resampler.py
(reference multimodal_resampler/*).  LaViDa ships with the identity; the
alternates:

  masked_drop   MAE-style random token drop at train time
                (masked_drop.py:7-89: fixed / range / cls_only modes and a
                skip probability).  The skip and the range ratio are
                decided on the host, as JAX decides them; the draws come
                from a torch.Generator, or are given (`draws`) so a test
                can hold the port to JAX's jax.random draws.  The kept
                tokens are those of the smallest noise, ties broken by
                position (a stable sort, as jnp.argsort's);
  spatial_pool  stride pooling over the token grid, average or max
                (spatial_pool.py:6-45; its conv mode is the "pooler"
                projector, models/projector.py);
  perceiver     Flamingo's PerceiverResampler (perceiver.py:30-160):
                learned latents cross-attend to [media; latents], the
                scores less their row max, an ff_mult MLP, a final LN;
  qformer       BLIP-2's Q-Former (models/qformer.py).

The perceiver's attention is plain XLA in the JAX package, so plain torch
ops are its port, in JAX's op order (the scale rounded to the features'
dtype, jax.nn.softmax's exp and division).  `build_resampler`
(resampler.py:160-198) is the name registry; every resampler is an
nn.Module whose forward takes (features, generator=None,
training=False), and the Q-Former keeps the reference's
quirk: `depth` feeds its cross_attention_freq, not its layer count
(qformer.py:1102-1133).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import QformerConfig
from ..ops.activations import gelu_erf
from ..ops.pooling import pool_2d
from .qformer import Qformer
from .siglip import LayerNorm


def masked_drop(features: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mode: str = "fixed", ratio: float = 0.5,
                ratio_upper: float = 0.75, ratio_lower: float = 0.25,
                skip_percentage: float = 0.0, training: bool = True,
                draws: Optional[dict] = None) -> torch.Tensor:
    """A random token subset of each image [N, T, D] (masked_drop.py
    random_masking; resampler.py:37-69).  `draws` gives the draws instead
    of the generator: "skip" (uniform in [0, 1)), "ratio" (the range
    mode's ratio) and "noise" [N, T]."""
    if not training:
        return features
    N, T, _ = features.shape

    def draw(key, *shape, low=0.0, high=1.0):
        if draws is not None:
            return draws[key]
        u = torch.rand(shape, generator=generator, device=features.device)
        return low + (high - low) * u

    if skip_percentage > 0 and float(draw("skip")) < skip_percentage:
        return features
    if mode == "cls_only":
        return features[:, :1]
    if mode == "fixed":
        keep = int(T * ratio)
    elif mode == "range":
        r = float(draw("ratio", low=ratio_lower, high=ratio_upper))
        keep = max(int(T * r), 1)
    else:
        raise ValueError(f"Unexpected masked drop mode: {mode}")
    noise = torch.as_tensor(draw("noise", N, T), device=features.device)
    ids = torch.argsort(noise, dim=1, stable=True)[:, :keep]
    return torch.take_along_dim(features, ids[..., None], dim=1)


def spatial_pool(features: torch.Tensor, mode: str = "average",
                 stride: int = 2) -> torch.Tensor:
    """[N, g*g, D] -> pooled (spatial_pool.py:24-32)."""
    if mode not in ("average", "max"):
        raise ValueError(f"spatial_pool mode {mode!r}: average or max")
    return pool_2d(features, mode, stride)


class PerceiverLayer(nn.Module):
    def __init__(self, dim: int, inner: int, ff_mult: int, device,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm_media = LayerNorm(dim, 1e-5, **kw)
        self.norm_latents = LayerNorm(dim, 1e-5, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)
        self.ff_norm = LayerNorm(dim, 1e-5, **kw)
        self.ff1 = nn.Linear(dim, dim * ff_mult, bias=False, **kw)
        self.ff2 = nn.Linear(dim * ff_mult, dim, bias=False, **kw)


class Perceiver(nn.Module):
    """PerceiverResampler (resampler.py:90-155)."""

    def __init__(self, dim: int, depth: int = 6, dim_head: int = 64,
                 heads: int = 8, num_latents: int = 64, ff_mult: int = 4,
                 device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads, self.dim_head = heads, dim_head
        self.latents = nn.Parameter(torch.zeros(num_latents, dim, **kw))
        self.layers = nn.ModuleList(
            PerceiverLayer(dim, dim_head * heads, ff_mult, **kw)
            for _ in range(depth))
        self.norm = LayerNorm(dim, 1e-5, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "Perceiver":
        """Seeded weights as init_perceiver draws them: each linear ~
        N(0, 1 / its input width), the latents ~ N(0, 1), norms at one."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.latents.normal_(0.0, 1.0, generator=generator)
        return self

    def forward(self, features: torch.Tensor, generator=None,
                training: bool = False) -> torch.Tensor:
        """[B, v, D] image tokens -> [B, num_latents, D]."""
        B = features.shape[0]
        h, hd = self.heads, self.dim_head
        lat = self.latents[None].expand(B, -1, -1).to(features.dtype)
        for p in self.layers:
            x = p.norm_media(features)
            l_in = p.norm_latents(lat)
            q = (l_in @ p.to_q.weight.t()).unflatten(-1, (h, hd))
            kv = torch.cat([x, l_in], dim=1) @ p.to_kv.weight.t()
            k, v = (t.unflatten(-1, (h, hd)) for t in kv.chunk(2, dim=-1))
            scale = torch.tensor(hd ** -0.5, dtype=q.dtype, device=q.device)
            sim = torch.einsum("bihd,bjhd->bhij", q * scale, k)
            # jax.nn.softmax's op order: exp, then over its sum
            e = torch.exp(sim - sim.amax(dim=-1, keepdim=True))
            attn = e / e.sum(dim=-1, keepdim=True)
            out = torch.einsum("bhij,bjhd->bihd", attn, v).flatten(-2)
            lat = lat + out @ p.to_out.weight.t()
            z = gelu_erf(p.ff_norm(lat) @ p.ff1.weight.t())
            lat = lat + z @ p.ff2.weight.t()
        return self.norm(lat)


class Identity(nn.Module):
    def forward(self, features, generator=None, training=False):
        return features


class MaskedDrop(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.kw = kw

    def forward(self, features, generator=None, training=False):
        if generator is None:           # JAX's default PRNGKey(0)
            generator = torch.Generator(features.device).manual_seed(0)
        return masked_drop(features, generator, training=training,
                           **self.kw)


class SpatialPool(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.kw = kw

    def forward(self, features, generator=None, training=False):
        return spatial_pool(features, **self.kw)


class QformerResampler(Qformer):
    def forward(self, features, generator=None, training=False):
        return super().forward(features)


def build_resampler(name: Optional[str], dim: int = 1152,
                    generator: Optional[torch.Generator] = None,
                    device="cuda", **kw) -> nn.Module:
    """The resampler module of `name` (multimodal_resampler/builder.py's
    dispatch; None / "identity" is LaViDa's).  The perceiver and the
    Q-Former draw their weights from `generator` (required, as JAX's key
    is) on `device`, in f32 unless `dtype` is given."""
    if name in (None, "identity"):
        return Identity()
    if name == "masked_drop":
        return MaskedDrop(**kw)
    if name == "spatial_pool":
        return SpatialPool(**kw)
    if name in ("perceiver", "qformer") and generator is None:
        raise ValueError(f"resampler {name!r} draws its weights: give a "
                         f"generator")
    dtype = kw.pop("dtype", torch.float32)
    if name == "perceiver":
        return Perceiver(dim, device=device, dtype=dtype,
                         **kw).reset_parameters(generator)
    if name == "qformer":
        cfg = QformerConfig(
            encoder_width=dim,
            num_query_tokens=kw.pop("latents", kw.pop("num_latents", 32)),
            cross_attention_freq=kw.pop("depth", 2), **kw)
        return QformerResampler(cfg, device, dtype).reset_parameters(
            generator)
    raise ValueError(f"unknown resampler: {name}")

