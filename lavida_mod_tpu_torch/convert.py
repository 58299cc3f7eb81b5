"""Weights carried across: the JAX package's LaViDa params -> this
package's state dict.

The input is the JAX params pytree with every leaf a numpy array
(`jax.tree.map(np.asarray, params)`): LLaDA blocks stacked [L, ...] or
listed by `unstack_blocks` (llada.py:796), SigLIP layers stacked [L, ...],
the projector's layer list, `image_newline`, `wte` and the `ff_out` head.
JAX linear kernels are [in, out]; nn.Linear weights are [out, in], the HF
checkpoint layout, so every kernel is transposed here.

Every leaf is mapped or the conversion raises: a quantized leaf
(`kernel_q`, `kernel_p4`, ...), a LoRA factor or any unknown name is an
error, never dropped.
"""

from __future__ import annotations

import numpy as np
import torch

_LLADA_LINEARS = ("q_proj", "k_proj", "v_proj", "attn_out", "ff_proj",
                  "up_proj", "ff_out")
_LLADA_NORMS = ("attn_norm", "ff_norm")
_SIGLIP_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
_SIGLIP_NORMS = ("ln1", "ln2")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (i,))
    else:
        yield prefix, tree


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _linear_weight(kernel) -> torch.Tensor:
    return _tensor(np.ascontiguousarray(np.asarray(kernel).T))


def _unmapped(path) -> Exception:
    leaf = path[-1]
    if isinstance(leaf, str) and (leaf.startswith(("kernel_", "scale"))
                                  or leaf.startswith("__trim_")):
        why = "a quantized leaf: the port has no quantized layout yet"
    elif isinstance(leaf, str) and leaf.startswith("lora_"):
        why = "a LoRA factor: merge it into the kernel first"
    else:
        why = "no counterpart in the port"
    return ValueError(f"cannot convert params leaf {'/'.join(map(str, path))}"
                      f": {why}")


def _linear_leaf(name, leaf, arr, path, out):
    """A linear's kernel (transposed to .weight) or bias."""
    if leaf == "kernel":
        out[f"{name}.weight"] = _linear_weight(arr)
    elif leaf == "bias":
        out[f"{name}.bias"] = _tensor(arr)
    else:
        raise _unmapped(path)


def _layer_leaf(prefix, layer, mod, leaf, arr, linears, norms, path, out):
    """One per-layer leaf: a linear's kernel/bias or a norm's weight/bias."""
    if mod in linears:
        _linear_leaf(f"{prefix}.{layer}.{mod}", leaf, arr, path, out)
    elif mod in norms and leaf in ("weight", "bias"):
        out[f"{prefix}.{layer}.{mod}.{leaf}"] = _tensor(arr)
    else:
        raise _unmapped(path)


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX LaViDa params (numpy leaves) -> `LaViDa` state dict (CPU
    tensors in the leaves' dtype)."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        top, n = path[0], len(path)
        if path == ("image_newline",):
            out["image_newline"] = _tensor(arr)
        elif path == ("llada", "wte"):
            out["llada.wte.weight"] = _tensor(arr)
        elif path == ("llada", "ln_f", "weight"):
            out["llada.ln_f.weight"] = _tensor(arr)
        elif path == ("llada", "ff_out", "kernel"):
            out["llada.ff_out.weight"] = _linear_weight(arr)
        elif top == "llada" and n == 5 and path[1] == "blocks" \
                and isinstance(path[2], int):
            # unstacked: blocks[i][mod][leaf]
            _layer_leaf("llada.blocks", path[2], path[3], path[4], arr,
                        _LLADA_LINEARS, _LLADA_NORMS, path, out)
        elif top == "llada" and n == 4 and path[1] == "blocks":
            # stacked: blocks[mod][leaf] of shape [L, ...]
            for i, a in enumerate(np.asarray(arr)):
                _layer_leaf("llada.blocks", i, path[2], path[3], a,
                            _LLADA_LINEARS, _LLADA_NORMS, path, out)
        elif top == "siglip" and n == 3 and path[1] == "patch_embed":
            _linear_leaf("siglip.patch_embed", path[2], arr, path, out)
        elif path == ("siglip", "pos_embed"):
            out["siglip.pos_embed"] = _tensor(arr)
        elif top == "siglip" and n == 4 and path[1] == "layers":
            for i, a in enumerate(np.asarray(arr)):
                _layer_leaf("siglip.layers", i, path[2], path[3], a,
                            _SIGLIP_LINEARS, _SIGLIP_NORMS, path, out)
        elif top == "projector" and n == 4 and path[1] == "layers":
            _linear_leaf(f"projector.layers.{path[2]}", path[3], arr, path,
                         out)
        else:
            raise _unmapped(path)
    return out
