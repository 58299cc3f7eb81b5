"""2D spatial token pooling: the port of lavida_mod_tpu/ops/pooling.py
(reference llava_arch.py:198-233 get_2dPool).

Operates on projected vision tokens [N, g*g, D]:
  - "average"/"max": kernel = stride -> floor(g / stride) per side;
  - "bilinear": torch F.interpolate to ceil(g / stride), align_corners=False
    and no antialias, expressed as two f32 products with the same static
    2-tap weight matrix as the JAX package (`_interp_matrix`), so both
    packages compute the same sums.
LaViDa's default is bilinear stride 2: 27x27 = 729 -> 14x14 = 196 per view.

`_bilinear_no_antialias` (pooling.py:34-53) is that resize of a whole
[N, g, g, D] grid to any side, in f32; S2 brings each scale's grid back to
the base grid with it (models/clip.py).  `resize_weights` builds the
[out, in] matrix of jax.image.resize's "bilinear" or "bicubic" rule along
one axis, antialiased when it shrinks (jax/_src/image/scale.py
compute_weight_mat), which F.interpolate does not follow (SigLIP's
bicubic position table, models/siglip.py); `resize` applies the bilinear
one as jax.image.resize does (S2's image resize).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _interp_matrix(g: int, go: int) -> np.ndarray:
    """[go, g] 2-tap bilinear weights, half-pixel centers, no antialias."""
    scale = g / go
    src = np.maximum((np.arange(go, dtype=np.float64) + 0.5) * scale - 0.5,
                     0.0).astype(np.float32)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, g - 1)
    w1 = src - i0.astype(np.float32)
    W = np.zeros((go, g), np.float32)
    np.add.at(W, (np.arange(go), i0), 1.0 - w1)
    np.add.at(W, (np.arange(go), i1), w1)
    return W


def _bilinear_no_antialias(grid: torch.Tensor, go: int) -> torch.Tensor:
    """[N, g, g, D] -> [N, go, go, D] in f32: F.interpolate(mode="bilinear",
    align_corners=False, antialias=False) as two f32 products with the
    2-tap matrix, rows first (pooling.py:34-53)."""
    W = torch.from_numpy(_interp_matrix(grid.shape[1], go)).to(grid.device)
    rows = torch.einsum("og,ngwd->nowd", W, grid.float())
    return torch.einsum("pw,nowd->nopd", W, rows)


def _triangle(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    return np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys kernel with a = -0.5."""
    f32 = np.float32
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x
                 + f32(2.0), w)
    return np.where(x >= 2.0, f32(0.0), w).astype(f32)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """[n_out, n_in] f32 weights of jax.image.resize's `method` along one
    axis (compute_weight_mat with scale n_out / n_in, no translation,
    antialias on: the kernel widened by the shrink factor)."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kscale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


def resize(x: torch.Tensor, size: int, dims: tuple[int, int]
           ) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") of the float x's axes `dims` to
    `size` each: one product per axis whose side changes, in order, with
    the weights cast to x's dtype and each product rounded to it (jax's
    einsum)."""
    for d in dims:
        n = x.shape[d]
        if n == size:
            continue
        w = torch.from_numpy(resize_weights(n, size, "bilinear")).to(
            device=x.device, dtype=x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [1])), -1, d)
    return x


def pool_2d(x: torch.Tensor, mode: str = "bilinear",
            stride: int = 2) -> torch.Tensor:
    """x [N, T, D] with T a perfect square -> [N, T', D] in x's dtype."""
    N, T, D = x.shape
    g = int(round(math.sqrt(T)))
    if g * g != T:
        raise ValueError(f"pool_2d: {T} tokens is not a square grid")
    grid = x.reshape(N, g, g, D)
    if mode in ("average", "max"):
        go = g // stride
        t = grid[:, :go * stride, :go * stride].reshape(
            N, go, stride, go, stride, D)
        out = t.mean(dim=(2, 4)) if mode == "average" else t.amax(dim=(2, 4))
    elif mode == "bilinear":
        out = _bilinear_no_antialias(grid, math.ceil(g / stride)).to(x.dtype)
    else:
        raise ValueError(f"Unexpected pool mode: {mode}")
    return out.reshape(N, -1, D)
