"""Weights carried across: the JAX package's LaViDa params -> this
package's state dict.

The input is the JAX params pytree with every leaf a numpy array
(`jax.tree.map(np.asarray, params)`): LLaDA blocks stacked [L, ...] or
listed by `unstack_blocks` (llada.py:796), in the llama layout or the
fused sequential one (`att_proj`), SigLIP layers stacked [L, ...], the
projector's layer list, `image_newline`, `wte` and the `ff_out` head.
JAX linear kernels are [in, out]; nn.Linear weights are [out, in], the HF
checkpoint layout, so every kernel is transposed here.

The LM's linears may be quantized (`quantize_params`, llada.py:807-866):
  - int8 `{kernel_q [K, N] int8, scale [N] f32}` -> `.weight_q` [N, K]
    (transposed: the W8A8 kernel reads K-major operands) and `.scale`;
  - int4 `{kernel_p4 [K/2, N] int8, scales4 [K/128, N] f32, __trim_N__}`
    -> `.packed` in the fragment layout of ops/quant.py (re-packed from
    the JAX nibble order) and `.scales` as they are; `__trim_N__` becomes
    a `.__trim__` entry that `LaViDa.from_jax` checks against the config.
`prefill_state_from_jax` maps the mixed layout's int8 prefill tree onto
`blocks.i.prefill.*`; its embedding, ln_f and norms must be the decode
tree's (they are shared), and its int8 head is not kept (the prefill
returns no logits).

Every other leaf is mapped or the conversion raises: a quantized leaf
outside the LM, a LoRA factor or any unknown name is an error, never
dropped.

Training: the JAX package's f32 tree (`multimodal.init_params` after
`cast_floating(f32)`) becomes the compute model through `LaViDa.from_jax`
(cast to the compute dtype) and the f32 masters through
`masters_from_jax`, which `train.step.init_train_state` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.quant import w4_from_jax_packed

_LLADA_LINEARS = ("q_proj", "k_proj", "v_proj", "att_proj", "attn_out",
                  "ff_proj", "up_proj", "ff_out")
_LLADA_NORMS = ("attn_norm", "ff_norm")
_SIGLIP_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
_SIGLIP_NORMS = ("ln1", "ln2")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(k, str) and k.startswith("__trim_"):
                yield prefix + (k,), None      # static metadata, no array
                continue
            yield from _flatten(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (i,))
    else:
        yield prefix, tree


def _check_linear_kinds(tree, prefix=()):
    """Raise for a linear that holds more than one kind of kernel (float,
    int8, int4): such a dict has no single meaning."""
    if isinstance(tree, dict):
        kinds = {"kernel", "kernel_q", "kernel_p4"} & set(tree)
        if len(kinds) > 1:
            raise ValueError(f"cannot convert params leaf "
                             f"{'/'.join(map(str, prefix))}: a linear with "
                             f"{sorted(kinds)} at once")
        for k, v in tree.items():
            _check_linear_kinds(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _check_linear_kinds(v, prefix + (i,))


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
        why = "a quantized leaf outside the LM's linears (only they are"
        why += " quantized in the port)"
    elif isinstance(leaf, str) and leaf.startswith("lora_"):
        why = "a LoRA factor: merge it into the kernel first"
    else:
        why = "no counterpart in the port"
    return ValueError(f"cannot convert params leaf {'/'.join(map(str, path))}"
                      f": {why}")


def _linear_leaf(name, leaf, arr, path, out, quantized=False):
    """A linear's kernel (transposed to .weight) or bias; with `quantized`
    also its int8 or int4 leaves."""
    if leaf == "kernel":
        out[f"{name}.weight"] = _linear_weight(arr)
    elif leaf == "bias":
        out[f"{name}.bias"] = _tensor(arr)
    elif quantized and leaf == "kernel_q":
        out[f"{name}.weight_q"] = _linear_weight(arr)
    elif quantized and leaf == "scale":
        out[f"{name}.scale"] = _tensor(np.asarray(arr, np.float32))
    elif quantized and leaf == "kernel_p4":
        out[f"{name}.packed"] = w4_from_jax_packed(np.asarray(arr))
    elif quantized and leaf == "scales4":
        out[f"{name}.scales"] = _tensor(np.asarray(arr, np.float32))
    elif quantized and isinstance(leaf, str) and leaf.startswith("__trim_"):
        out[f"{name}.__trim__"] = torch.tensor(int(leaf[7:-2]))
    else:
        raise _unmapped(path)


def _layer_leaf(prefix, layer, mod, leaf, arr, linears, norms, path, out,
                quantized=False):
    """One per-layer leaf: a linear's kernel/bias or a norm's weight/bias."""
    if mod in linears:
        _linear_leaf(f"{prefix}.{layer}.{mod}", leaf, arr, path, out,
                     quantized)
    elif mod in norms and leaf in ("weight", "bias"):
        out[f"{prefix}.{layer}.{mod}.{leaf}"] = _tensor(arr)
    else:
        raise _unmapped(path)


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX LaViDa params (numpy leaves) -> `LaViDa` state dict (CPU
    tensors in the leaves' dtype)."""
    _check_linear_kinds(params)
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        top, n = path[0], len(path)
        if path == ("image_newline",):
            out["image_newline"] = _tensor(arr)
        elif path == ("llada", "wte"):
            out["llada.wte.weight"] = _tensor(arr)
        elif path == ("llada", "ln_f", "weight"):
            out["llada.ln_f.weight"] = _tensor(arr)
        elif top == "llada" and n == 3 and path[1] == "ff_out":
            _linear_leaf("llada.ff_out", path[2], arr, path, out, True)
        elif top == "llada" and n == 5 and path[1] == "blocks" \
                and isinstance(path[2], int):
            # unstacked: blocks[i][mod][leaf]
            _layer_leaf("llada.blocks", path[2], path[3], path[4], arr,
                        _LLADA_LINEARS, _LLADA_NORMS, path, out, True)
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


def masters_from_jax(params: dict, device="cuda") -> dict[str, torch.Tensor]:
    """The JAX f32 training tree (numpy leaves) -> f32 master tensors by
    state-dict name on `device` (the card unless the caller asks for the
    CPU)."""
    return {n: t.to(device=device, dtype=torch.float32)
            for n, t in state_dict_from_jax(params).items()}


def prefill_state_from_jax(prefill: dict, llada: dict) -> dict:
    """The mixed layout's int8 prefill tree (`LaViDa.prefill_params`, an
    unstacked LLaDA params dict, numpy leaves) -> `llada.blocks.i.prefill.*`
    entries.  Its shared leaves must equal the decode tree `llada`'s."""
    _check_linear_kinds(prefill)
    dec = dict(_flatten(llada))
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(prefill):
        n = len(path)
        if path[0] == "ff_out":
            continue                          # the prefill returns no logits
        if path in (("wte",), ("ln_f", "weight")) or (
                n == 4 and path[0] == "blocks" and path[2] in _LLADA_NORMS):
            if path not in dec or not np.array_equal(
                    np.asarray(dec[path]), np.asarray(arr)):
                raise ValueError(f"prefill leaf {'/'.join(map(str, path))}"
                                 f" differs from the decode tree's; the "
                                 f"port shares it")
        elif n == 4 and path[0] == "blocks" and isinstance(path[1], int) \
                and path[2] in _LLADA_LINEARS \
                and path[3] in ("kernel_q", "scale"):
            _linear_leaf(f"llada.blocks.{path[1]}.prefill.{path[2]}",
                         path[3], arr, path, out, True)
        else:
            raise _unmapped(("prefill",) + path)
    return out
