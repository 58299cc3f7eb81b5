"""2D spatial token pooling: the port of lavida_mod_tpu/ops/pooling.py
(reference llava_arch.py:198-233 get_2dPool).

Operates on projected vision tokens [N, g*g, D]:
  - "average"/"max": kernel = stride -> floor(g / stride) per side;
  - "bilinear": torch F.interpolate to ceil(g / stride), align_corners=False
    and no antialias, expressed as two f32 products with the same static
    2-tap weight matrix as the JAX package (`_interp_matrix`), so both
    packages compute the same sums.
LaViDa's default is bilinear stride 2: 27x27 = 729 -> 14x14 = 196 per view.
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
        go = math.ceil(g / stride)
        W = torch.from_numpy(_interp_matrix(g, go)).to(x.device)
        rows = torch.einsum("og,ngwd->nowd", W, grid.float())
        out = torch.einsum("pw,nowd->nopd", W, rows).to(x.dtype)
    else:
        raise ValueError(f"Unexpected pool mode: {mode}")
    return out.reshape(N, -1, D)
