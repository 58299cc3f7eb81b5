"""Vision -> LM projector, ported from lavida_mod_tpu/models/projector.py
(the reference's mm_projector factory, multimodal_projector :44-50):
"mlp{N}x_gelu", N Linears with an EXACT (erf) GELU between them, torch
nn.GELU's default.  LaViDa uses mlp2x_gelu (1152 -> 4096 -> 4096).  The
other projector kinds of the JAX package raise NotImplementedError.

`port_name` maps the reference's Sequential names (mm_projector.0.weight,
.2.weight, ...: a Linear at every even index, the GELUs between them,
projector.py:139-147) onto `layers.{index // 2}`.

The forward reads each linear's weight and bias only, as the JAX
projector does (`h @ kernel + bias`, projector.py:99-103): LoRA factors
attached there (train/lora.py's SHIRG recipe targets both linears) do not
act and get no gradient (ROADMAP Queue 3)."""

from __future__ import annotations

import re

import torch
from torch import nn

from ..ops.activations import gelu_erf


def mlp_depth(projector_type: str) -> int:
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m is None:
        raise NotImplementedError(
            f"projector {projector_type!r}: only mlp{{N}}x_gelu is ported")
    return int(m.group(1))


class Projector(nn.Module):
    def __init__(self, projector_type: str, mm_hidden: int, hidden: int,
                 device, dtype=None):
        super().__init__()
        depth = mlp_depth(projector_type)
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [nn.Linear(mm_hidden, hidden, **kw)]
            + [nn.Linear(hidden, hidden, **kw) for _ in range(depth - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, tokens, mm_hidden] -> [N, tokens, hidden]."""
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = gelu_erf(x)
            x = torch.nn.functional.linear(x, layer.weight, layer.bias)
        return x


def port_name(name: str, projector_type: str) -> str:
    """`name` after "mm_projector." -> the Projector's state-dict name."""
    idx, _, leaf = name.partition(".")
    depth = mlp_depth(projector_type)
    if idx.isdigit() and int(idx) % 2 == 0 and int(idx) // 2 < depth \
            and leaf in ("weight", "bias"):
        return f"layers.{int(idx) // 2}.{leaf}"
    raise ValueError(f"mm_projector.{name}: no weight of the {depth}-layer "
                     f"{projector_type} projector has this name")
