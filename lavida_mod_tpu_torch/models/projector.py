"""Vision -> LM projector, ported from lavida_mod_tpu/models/projector.py
(the reference's mm_projector factory, multimodal_projector/builder.py).
Every kind of `parse_projector_type` (projector.py:26-35):

  - "mlp{N}x_gelu": N Linears with an EXACT (erf) GELU between them, torch
    nn.GELU's default.  LaViDa uses mlp2x_gelu (1152 -> 4096 -> 4096);
  - "mlp{N}x_res{M}x_gelu": the same, then M pre-norm residual blocks
    (SimpleResBlock: z = LN(h); h = z + fc2(gelu(fc1(z))), :104-110);
  - "linear": one Linear (the layer list of one);
  - "identity": no weights; the features must already have the LM's
    width (mm_hidden == hidden), else the splice could not concatenate
    them, so the module refuses other widths where it is built;
  - "pooler" (pooler_projector.py:9-35): a conv with kernel = stride = r
    over the token grid, as a block reshape and one Linear of [O, D*r*r]
    (the conv weight [O, D, r, r] flattened in (D, rh, rw) order), an
    exact GELU, then a Linear; the grid must divide by r (:92).

The forward reads each linear's weight and bias only, as the JAX
projector does (`h @ kernel + bias`, projector.py:99-103, the product
rounded before the bias is added, `ops/linear.py`): LoRA factors
attached there (train/lora.py's SHIRG recipe targets the projector's
linears) do not act and get no gradient (ROADMAP Queue 3).

`port_name` maps the reference's names below "mm_projector." onto the
module's: the Sequential indices of the mlp kinds (a Linear at every even
index below 2N, projector.py:139-147), `weight` / `bias` at the root for
"linear", `conv_pool.*` and `proj.1.*` for "pooler" (:128-135).  JAX's
converter reads no residual block (it returns `layers` only), so a loaded
res projector runs without them in both packages: both of LaViDa's
loaders call `Projector.drop_res_blocks`, and port_name maps the blocks'
names to None; ROADMAP Queue 3 records it.
"""

from __future__ import annotations

import math
import re
from typing import Any, Optional

import torch
from torch import nn

from ..ops.activations import gelu_erf
from ..ops.linear import linear
from .siglip import LayerNorm

POOLER_RATIO = 2      # projector.py:73, the ratio every caller uses


def parse_projector_type(projector_type: str) -> dict[str, Any]:
    if projector_type in ("linear", "identity", "pooler"):
        return {"kind": projector_type}
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        return {"kind": "mlp", "depth": int(m.group(1)), "res": 0}
    m = re.match(r"^mlp(\d+)x_res(\d+)x_gelu$", projector_type)
    if m:
        return {"kind": "mlp", "depth": int(m.group(1)),
                "res": int(m.group(2))}
    raise ValueError(f"Unknown projector type: {projector_type}")


class ResBlock(nn.Module):
    """SimpleResBlock: pre_norm, then fc1 -> GELU -> fc2 added to the
    normed input."""

    def __init__(self, hidden: int, device, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pre_norm = LayerNorm(hidden, 1e-5, **kw)
        self.fc1 = nn.Linear(hidden, hidden, **kw)
        self.fc2 = nn.Linear(hidden, hidden, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        z = self.pre_norm(h)
        return z + linear(gelu_erf(linear(z, self.fc1)), self.fc2)


class Projector(nn.Module):
    def __init__(self, projector_type: str, mm_hidden: int, hidden: int,
                 device, dtype=None):
        super().__init__()
        spec = parse_projector_type(projector_type)
        kw = dict(device=device, dtype=dtype)
        self.kind = spec["kind"]
        self.layers = nn.ModuleList()
        self.res_blocks = nn.ModuleList()
        if self.kind == "identity":
            if mm_hidden != hidden:
                raise ValueError(f"identity projector: features of width "
                                 f"{mm_hidden} for an LM of {hidden}")
        elif self.kind == "pooler":
            r = POOLER_RATIO
            self.conv = nn.Linear(mm_hidden * r * r, hidden, **kw)
            self.proj = nn.Linear(hidden, hidden, **kw)
        else:
            depth = 1 if self.kind == "linear" else spec["depth"]
            self.layers.extend(
                [nn.Linear(mm_hidden, hidden, **kw)]
                + [nn.Linear(hidden, hidden, **kw) for _ in range(depth - 1)])
            self.res_blocks.extend(ResBlock(hidden, **kw)
                                   for _ in range(spec.get("res", 0)))

    def drop_res_blocks(self) -> None:
        """A loaded projector's residual blocks: none.  JAX's converter
        returns `layers` only (projector.py:139-147) and its forward reads
        params.get("res_blocks", []) (:104), so a res projector loaded
        from a checkpoint, or carried from params that lack the blocks,
        runs without them; `port_name` skips their weights to match."""
        self.res_blocks = nn.ModuleList()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, tokens, mm_hidden] -> [N, tokens', hidden] (projector.py:
        73-111)."""
        if self.kind == "identity":
            return x
        if self.kind == "pooler":
            N, T, D = x.shape
            g, r = int(round(math.sqrt(T))), POOLER_RATIO
            if g % r:
                raise ValueError(f"pooler requires grid divisible by "
                                 f"ratio: a {g} x {g} grid, ratio {r}")
            xg = x.reshape(N, g // r, r, g // r, r, D).permute(
                0, 1, 3, 5, 2, 4).reshape(N, (g // r) ** 2, D * r * r)
            return linear(gelu_erf(linear(xg, self.conv)), self.proj)
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = gelu_erf(x)
            x = linear(x, layer)
        for block in self.res_blocks:
            x = block(x)
        return x


_RES = re.compile(r"(\d+)\.(pre_norm|proj\.0|proj\.2)\.(weight|bias)")


def port_name(name: str, projector_type: str) -> Optional[str]:
    """`name` after "mm_projector." -> the Projector's state-dict name, or
    None for a residual block's weight (JAX's converter reads none);
    raises for any other name."""
    spec = parse_projector_type(projector_type)
    kind = spec["kind"]
    idx, _, leaf = name.partition(".")
    if kind == "linear" and name in ("weight", "bias"):
        return f"layers.0.{name}"
    if kind == "pooler" and name in ("conv_pool.weight", "conv_pool.bias",
                                     "proj.1.weight", "proj.1.bias"):
        return name.replace("conv_pool", "conv").replace("proj.1", "proj")
    if kind == "mlp":
        depth = spec["depth"]
        if idx.isdigit() and int(idx) % 2 == 0 and int(idx) // 2 < depth \
                and leaf in ("weight", "bias"):
            return f"layers.{int(idx) // 2}.{leaf}"
        m = _RES.fullmatch(name)
        if m and 2 * depth - 1 <= int(m.group(1)) < 2 * depth - 1 + \
                spec["res"]:
            return None
    raise ValueError(f"mm_projector.{name}: no weight of the "
                     f"{projector_type} projector has this name")
