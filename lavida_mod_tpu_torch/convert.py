"""Weights carried across: the JAX package's LaViDa params -> this
package's state dict.

The input is the JAX params pytree with every leaf a numpy array
(`jax.tree.map(np.asarray, params)`): LLaDA blocks stacked [L, ...] or
listed by `unstack_blocks` (llada.py:796), in the llama layout or the
fused sequential one (`att_proj`), SigLIP layers stacked [L, ...], the
projector's layer list, `image_newline`, `wte` and the `ff_out` head
(absent from a tied config's tree: the port's head is then wte's).
JAX linear kernels are [in, out]; nn.Linear weights are [out, in], the HF
checkpoint layout, so every kernel is transposed here.

A block's "moe" entry (models/moe.py: the router [D, E] and the experts'
stacked [E, in, out] kernels) maps to `blocks.i.moe.{router, ff_proj,
up_proj, ff_out}` in the JAX orientation, and `q_norm` / `k_norm` map as
the other norms.  The int8 SigLIP tower (`quantize_tower`, siglip.py:
69-81) maps its per-layer `{kernel_q [L, K, N], scale [L, N]}` as the
LM's int8 linears.

The LM's linears may be quantized (`quantize_params`, llada.py:807-866):
  - int8 `{kernel_q [K, N] int8, scale [N] f32}` -> `.weight_q` [N, K]
    (transposed: the W8A8 kernel reads K-major operands) and `.scale`;
  - int4 `{kernel_p4 [K/2, N] int8, scales4 [K/128, N] f32, __trim_N__}`
    -> `.packed` in the fragment layout of ops/quant.py (re-packed from
    the JAX nibble order) and `.scales` as they are; `__trim_N__` becomes
    a `.__trim__` entry that `LaViDa.from_jax` checks against the config.
`prefill_state_from_jax` maps the mixed layout's int8 prefill tree onto
`blocks.i.prefill.*` and its int8 head onto `prefill_head.*` (the Dream
sampler takes its first token from the prefill's logits); its embedding,
ln_f and norms must be the decode tree's (they are shared).  A linear's
bias (Qwen2's QKV bias: q/k/v in the llama layout, att_proj in the fused
one) maps to `.bias` in every tree.  LaViDa-Dream's LM is a tree of the
same names (`convert_dream_state_dict`, models/dream.py), so it converts
as LLaDA's does.

LoRA factors (train/lora.py) carry across with their linear: `lora_a`
[in, r] and `lora_b` [r, out] keep the JAX orientation (the port's forward
computes (x @ A) @ B as JAX does) and `lora_scale` becomes a 0-d entry,
one per layer of a stacked tree.  A linear with only some of the three, or
factors whose shapes do not chain [in, r] -> [r, out] over the linear's
widths, raises and names the leaf.

Every other leaf is mapped or the conversion raises: a quantized leaf
outside the LM or any unknown name is an error, never dropped.  The
projector's leaves of every kind map by name (models/projector.py):
`layers`, the pooler's `conv` and `proj`, the res kind's `res_blocks`.

The other vision towers (CLIP, open_clip, ImageBind, MLCD, EVA-CLIP), the
Q-Former and the perceiver convert with `module_from_jax(module, params)`:
their modules name their parameters as JAX's params name their leaves
(a stacked `layers` tree unstacked, kernels transposed to `.weight`, the
Q-Former's "self" / "cross" attention as `self_attn` / `cross_attn` and
its query FFN's leaves on the layer), and the module loads the result
strictly, so every leaf and every parameter is matched.

Training: the JAX package's f32 tree (`multimodal.init_params` after
`cast_floating(f32)`) becomes the compute model through `LaViDa.from_jax`
(cast to the compute dtype) and the f32 masters through
`masters_from_jax`, which `train.step.init_train_state` takes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.quant import w4_from_jax_packed

_LLADA_LINEARS = ("q_proj", "k_proj", "v_proj", "att_proj", "attn_out",
                  "ff_proj", "up_proj", "ff_out")
_LLADA_NORMS = ("attn_norm", "ff_norm", "q_norm", "k_norm")
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
        why = "a quantized leaf outside the LM's and the SigLIP tower's"
        why += " linears (only they are quantized in the port)"
    elif isinstance(leaf, str) and leaf.startswith("lora_"):
        why = "a LoRA factor outside the linears that carry one"
    else:
        why = "no counterpart in the port"
    return ValueError(f"cannot convert params leaf {'/'.join(map(str, path))}"
                      f": {why}")


LORA_LEAVES = ("lora_a", "lora_b", "lora_scale")


def _linear_leaf(name, leaf, arr, path, out, quantized=False):
    """A linear's kernel (transposed to .weight), bias or LoRA factor;
    with `quantized` also its int8 leaves, and its int4 ones unless
    `quantized` is "int8"."""
    if leaf == "kernel":
        out[f"{name}.weight"] = _linear_weight(arr)
    elif leaf == "bias":
        out[f"{name}.bias"] = _tensor(arr)
    elif leaf in LORA_LEAVES:
        t = _tensor(arr)
        if not t.is_floating_point():
            raise ValueError(f"cannot convert params leaf "
                             f"{'/'.join(map(str, path))}: a LoRA factor "
                             f"of {t.dtype}")
        out[f"{name}.{leaf}"] = t
        out.setdefault(_LORA_PATHS, {})[name] = "/".join(
            map(str, path[:-1]))
    elif quantized and leaf == "kernel_q":
        out[f"{name}.weight_q"] = _linear_weight(arr)
    elif quantized and leaf == "scale":
        out[f"{name}.scale"] = _tensor(np.asarray(arr, np.float32))
    elif quantized is True and leaf == "kernel_p4":
        out[f"{name}.packed"] = w4_from_jax_packed(np.asarray(arr))
    elif quantized is True and leaf == "scales4":
        out[f"{name}.scales"] = _tensor(np.asarray(arr, np.float32))
    elif quantized is True and isinstance(leaf, str) \
            and leaf.startswith("__trim_"):
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


_LORA_PATHS = "__lora_paths__"
_MOE_LEAVES = {("router", "kernel"): "router",
               ("experts", "ff_proj", "kernel"): "ff_proj",
               ("experts", "up_proj", "kernel"): "up_proj",
               ("experts", "ff_out", "kernel"): "ff_out"}


def _moe_leaf(layer, rest, arr, path, out):
    """One leaf of a block's "moe" entry (moe.py:27-50) ->
    `llada.blocks.<layer>.moe.<name>`, in the JAX orientation."""
    name = _MOE_LEAVES.get(tuple(rest))
    if name is None:
        raise _unmapped(path)
    out[f"llada.blocks.{layer}.moe.{name}"] = _tensor(arr)


def _in_out(out: dict, name: str):
    """The (in, out) widths of the converted linear `name`, or None."""
    for leaf in ("weight", "weight_q"):
        w = out.get(f"{name}.{leaf}")
        if w is not None:
            return w.shape[1], w.shape[0]
    return None


def _check_lora(out: dict) -> None:
    """Every linear with a LoRA leaf has all three, chained [in, r] ->
    [r, out] over its widths, and a 0-d scale; raises naming the leaf."""
    for name, jpath in out.pop(_LORA_PATHS, {}).items():
        got = {leaf: out.get(f"{name}.{leaf}") for leaf in LORA_LEAVES}
        missing = [leaf for leaf, t in got.items() if t is None]
        a, b, scale = (got[leaf] for leaf in LORA_LEAVES)
        io = _in_out(out, name)
        if missing:
            why = f"no {'/'.join(missing)} beside it"
        elif a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            why = (f"factors a {tuple(a.shape)}, b {tuple(b.shape)} do "
                   f"not chain")
        elif io is not None and (a.shape[0], b.shape[1]) != io:
            why = (f"factors [{a.shape[0]} -> {b.shape[1]}] on a linear "
                   f"[{io[0]} -> {io[1]}]")
        elif scale.dim() != 0:
            why = f"a lora_scale of shape {tuple(scale.shape)}"
        else:
            continue
        leaf = next(leaf for leaf in LORA_LEAVES if got[leaf] is not None)
        raise ValueError(f"cannot convert params leaf {jpath}/{leaf}: a "
                         f"malformed LoRA linear ({why})")


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX LaViDa params (numpy leaves) -> `LaViDa` state dict (CPU
    tensors in the leaves' dtype)."""
    _check_linear_kinds(params)
    out: dict = {}
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
        elif top == "llada" and n > 4 and path[1] == "blocks" \
                and isinstance(path[2], int) and path[3] == "moe":
            _moe_leaf(path[2], path[4:], arr, path, out)
        elif top == "llada" and n > 3 and path[1] == "blocks" \
                and path[2] == "moe":
            for i, a in enumerate(np.asarray(arr)):
                _moe_leaf(i, path[3:], a, path, out)
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
            # the int8 tower's per-(layer, out) scales (quantize_tower)
            for i, a in enumerate(np.asarray(arr)):
                _layer_leaf("siglip.layers", i, path[2], path[3], a,
                            _SIGLIP_LINEARS, _SIGLIP_NORMS, path, out,
                            "int8")
        elif top == "projector" and n == 4 and path[1] == "layers":
            _linear_leaf(f"projector.layers.{path[2]}", path[3], arr, path,
                         out)
        elif top == "projector" and n == 3 and path[1] in ("conv", "proj"):
            _linear_leaf(f"projector.{path[1]}", path[2], arr, path, out)
        elif top == "projector" and n == 5 and path[1] == "res_blocks":
            _layer_leaf("projector.res_blocks", path[2], path[3], path[4],
                        arr, ("fc1", "fc2"), ("pre_norm",), path, out)
        else:
            raise _unmapped(path)
    _check_lora(out)
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
    and `llada.prefill_head.*` entries.  Its shared leaves must equal the
    decode tree `llada`'s."""
    _check_linear_kinds(prefill)
    dec = dict(_flatten(llada))
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(prefill):
        n = len(path)
        if n == 2 and path[0] == "ff_out" and path[1] in ("kernel_q",
                                                          "scale"):
            _linear_leaf("llada.prefill_head", path[1], arr, path, out, True)
        elif path in (("wte",), ("ln_f", "weight")) or (
                n == 4 and path[0] == "blocks" and path[2] in _LLADA_NORMS):
            if path not in dec or not np.array_equal(
                    np.asarray(dec[path]), np.asarray(arr)):
                raise ValueError(f"prefill leaf {'/'.join(map(str, path))}"
                                 f" differs from the decode tree's; the "
                                 f"port shares it")
        elif n == 4 and path[0] == "blocks" and isinstance(path[1], int) \
                and path[2] in _LLADA_LINEARS \
                and path[3] in ("kernel_q", "scale", "bias"):
            _linear_leaf(f"llada.blocks.{path[1]}.prefill.{path[2]}",
                         path[3], arr, path, out, True)
        else:
            raise _unmapped(("prefill",) + path)
    return out


_QFORMER = {"self": "self_attn", "cross": "cross_attn"}


def _module_name(path) -> list[str]:
    """A leaf path of a tower's / resampler's JAX params -> the parts of
    the module's parameter name (the Q-Former's renames applied)."""
    parts = [str(p) for p in path]
    if len(parts) > 3 and parts[0] == "layers":
        if parts[2] == "ffn_q":     # layers[i]["ffn_q"][fc1 | fc2 | ln]
            parts = parts[:2] + [{"ln": "ffn_ln"}.get(parts[3], parts[3])] \
                + parts[4:]
        elif parts[2] in _QFORMER:
            parts[2] = _QFORMER[parts[2]]
    return parts


def module_state_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX params of a vision tower, the Q-Former or the perceiver
    (numpy leaves) -> the port module's state dict: a stacked `layers`
    dict [L, ...] unstacked, `kernel` [in, out] -> `weight` [out, in], a
    None leaf (ImageBind's pre_ln) and the perceiver's int hyperparameters
    left out."""
    out = {}
    for path, arr in _flatten(params):
        if arr is None or isinstance(arr, (int, float)):
            continue
        if path[0] == "layers" and isinstance(path[1], str):
            rows = [(("layers", i) + path[1:], a)
                    for i, a in enumerate(np.asarray(arr))]
        else:
            rows = [(path, arr)]
        for p, a in rows:
            parts = _module_name(p)
            if parts[-1] == "kernel":
                out[".".join(parts[:-1] + ["weight"])] = _linear_weight(a)
            else:
                out[".".join(parts)] = _tensor(a)
    return out


def module_from_jax(module: torch.nn.Module, params: dict, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """`module` (built on "meta" or anywhere) with the JAX params' weights,
    strictly matched, on `device` (the card unless the caller asks for the
    CPU), its parameters in the params' dtype unless `dtype` is given."""
    module.load_state_dict(module_state_from_jax(params), strict=True,
                           assign=True)
    module.to(device=device)
    if dtype is not None:
        for p in module.parameters():
            p.data = p.data.to(dtype)
    return module.eval()


def perceiver_from_jax(params: dict, device="cuda",
                       dtype: Optional[torch.dtype] = None):
    """The JAX `init_perceiver` params -> the port's Perceiver, its
    geometry read from the params' shapes and ints."""
    from .models.resampler import Perceiver

    num_latents, dim = np.shape(params["latents"])
    module = Perceiver(dim, depth=len(params["layers"]),
                       dim_head=params["dim_head"], heads=params["heads"],
                       num_latents=num_latents,
                       ff_mult=np.shape(params["layers"][0]["ff1"]["kernel"]
                                        )[1] // dim, device="meta")
    return module_from_jax(module, params, device, dtype)
