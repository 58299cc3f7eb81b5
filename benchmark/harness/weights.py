"""Seeded weights by leaf name, made on the device.

Every leaf has a generator of its own, seeded from (run seed, leaf name),
so either side can make any leaf alone and the reference can make them
again, layer by layer, after the program is freed.  The draws (the same
for both model families):
  - linear and embedding weights, SigLIP's position table: N(0, 0.02);
  - biases: N(0, 0.02) (zero biases would leave their paths untested);
  - norm weights: 1 + N(0, 0.02); LayerNorm biases N(0, 0.02);
  - the image newline: N(0, 1 / D).
"""

from __future__ import annotations

import hashlib

import torch


def leaf_seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _is_norm(name: str) -> bool:
    leaf = name.rsplit(".", 2)
    mod = leaf[-2] if len(leaf) > 1 else ""
    return mod.endswith("norm") or mod in ("ln1", "ln2", "ln_f")


def make_leaf(name: str, shape, dtype, device, seed: int) -> torch.Tensor:
    """The seeded value of leaf `name`, of `shape`, in `dtype`."""
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    if name == "image_newline":
        x = x * shape[-1] ** -0.5
    elif _is_norm(name) and name.endswith(".weight"):
        x = 1.0 + 0.02 * x
    else:
        x = 0.02 * x
    return x.to(dtype)


@torch.no_grad()
def fill_module(module: torch.nn.Module, seed: int) -> None:
    """Every parameter of `module` (made with to_empty) set to its seeded
    value, leaf by leaf, in its own dtype on its own device."""
    for name, p in module.named_parameters():
        p.copy_(make_leaf(name, p.shape, p.dtype, p.device, seed))


class Leaves:
    """W(name) for the reference: the seeded leaf of the program's model,
    by the program's shapes (read once, from a model on the meta
    device), in `dtype` on `device`."""

    def __init__(self, shapes: dict, dtype, device, seed: int):
        self.shapes, self.dtype, self.device, self.seed = (shapes, dtype,
                                                           device, seed)

    def __call__(self, name: str) -> torch.Tensor:
        return make_leaf(name, self.shapes[name], self.dtype, self.device,
                         self.seed)


def leaf_shapes(geo: dict, vcfg: dict) -> dict:
    """{leaf name: shape} of LaViDa's parameters under the port's names,
    from the configuration alone: the LM (`reference.lavida.lm_geometry`
    names), the tower and the mlp2x_gelu projector."""
    D, F, V = geo["D"], geo["F"], geo["V"]
    kvD = geo["Hkv"] * (D // geo["H"])
    out = {"image_newline": (D,), "llada.wte.weight": (V, D),
           "llada.ln_f.weight": (D,), "llada.ff_out.weight": (V, D)}
    for i in range(geo["L"]):
        p = f"llada.blocks.{i}"
        out.update({f"{p}.attn_norm.weight": (D,), f"{p}.ff_norm.weight": (D,),
                    f"{p}.q_proj.weight": (D, D), f"{p}.k_proj.weight": (kvD, D),
                    f"{p}.v_proj.weight": (kvD, D),
                    f"{p}.attn_out.weight": (D, D),
                    f"{p}.ff_proj.weight": (F, D), f"{p}.up_proj.weight": (F, D),
                    f"{p}.ff_out.weight": (D, F)})
        if geo["qkv_bias"]:
            out.update({f"{p}.q_proj.bias": (D,), f"{p}.k_proj.bias": (kvD,),
                        f"{p}.v_proj.bias": (kvD,)})
    W, I, P = vcfg["hidden_size"], vcfg["intermediate_size"], vcfg["patch_size"]
    g = vcfg["image_size"] // P
    out.update({"siglip.pos_embed": (g * g, W),
                "siglip.patch_embed.weight": (W, vcfg["num_channels"] * P * P),
                "siglip.patch_embed.bias": (W,)})
    for i in range(vcfg["num_hidden_layers"] - 1):
        p = f"siglip.layers.{i}"
        for n in ("ln1", "ln2"):
            out[f"{p}.{n}.weight"] = out[f"{p}.{n}.bias"] = (W,)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{p}.{n}.weight"], out[f"{p}.{n}.bias"] = (W, W), (W,)
        out[f"{p}.fc1.weight"], out[f"{p}.fc1.bias"] = (I, W), (I,)
        out[f"{p}.fc2.weight"], out[f"{p}.fc2.bias"] = (W, I), (W,)
    out.update({"projector.layers.0.weight": (D, W),
                "projector.layers.0.bias": (D,),
                "projector.layers.1.weight": (D, D),
                "projector.layers.1.bias": (D,)})
    return out
