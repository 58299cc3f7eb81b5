"""LaViDa: the composed multimodal masked-diffusion model, ported from
lavida_mod_tpu/models/lavida.py for the single-image serving slice.

An nn.Module holding the LLaDA LM, the SigLIP tower, the projector and the
image-newline vector, with the entry points:
  - `load(path, cfg=None, dtype, base=None, device)`: a reference-layout
    checkpoint directory (lavida.py:229-297), below;
  - `random_init(cfg, seed, dtype, device)`: seeded random weights made on
    the device itself (16 GB of LLaDA-8B never pass through the host);
  - `from_jax(cfg, params, device, prefill_params=None)`: weights carried
    over from the JAX package's params (a pytree of numpy arrays,
    convert.py), bf16 or after `to_serving_layout`;
  - `to_serving_layout(quant, fuse)`: the LM in a quantized serving layout
    (lavida.py:299-333), quantized where it lies;
  - `generate_fused(...)`: vision encode, the one-gather splice, the
    prefill into preallocated K/V buffers and the denoise loop, with the
    contract of the JAX `LaViDa.generate_fused` (lavida.py:533-601) run
    with use_flash_prefill=True; in the mixed layout the prefill runs the
    int8 tree with A8 activations (lavida.py:594-595);
  - `encode_prompt(...)` and `generate(...)`: the multi-dispatch path
    (lavida.py:430-531) the batched adapter runs, one image encode per
    image (or the given `image_features` blocks, SHIRG's) and the splice
    by concatenation, then `diffusion.generate`
    with optional front-padding to a bucket and the int8 KV cache, or,
    with a `DreamGenerationConfig`, the Dream sampler
    (`dream_sampler.dream_generate`, lavida.py:500-512) with its hooks.
`lm_family` is "llada" or "dream" (LaViDa-Dream: the Dream-7B LM, the
LLaDA core with Qwen2's QKV bias, models/dream.py); it picks the
checkpoint names and the eval adapter's sampler.
`decode_output(ids, tokenizer, stop_ids)` cuts a generation at EOS or the
conversation's stop ids and decodes it (lavida.py:603).

Checkpoints.  The published weights' names (LLaDAModelLM.base_model_prefix
"model", LlavaMetaModel's attributes):
  model.transformer.{wte,ln_f,ff_out,blocks.N.*}      -> llada
  model.vision_tower.vision_tower.vision_model.*      -> siglip
  model.mm_projector.{0,2}.{weight,bias}              -> projector
  model.image_newline                                 -> image_newline
map onto the state dict by name (`checkpoint_plan`; llada_loader, or
models/dream.py's map of the HF Dream names (model.layers.N.*,
model.embed_tokens, model.norm, lm_head) for LaViDa-Dream,
siglip.port_name, projector.port_name), every name with or without the
"model." prefix; a key that maps nowhere raises, and a missing newline
is zero (lavida.py:80-84).  `load_state_shards` maps the shards (the
port's own safetensors reader, tools/safetensors_io.py, or torch.load
with mmap for pytorch_model*.bin, whose floating tensors read as float32,
as the JAX package reads them) and returns lazy references, not arrays:
`fill_module` streams each tensor from its mapping into its parameter
on the device, in file order, and drops it, so host memory stays near
one tensor (the JAX package builds an f32 dict
of the whole checkpoint, 32 GB at 8B).  The projector overlay and the
peft adapter (non_lora_trainables overlaid, then `merge_lora_state`:
W + scale * (B @ A) in numpy f32, cast to W's dtype, as lavida.py:
121-153 does it) are the two delta modes of `base`.

`use_vision_fused_mlp` (lavida.py:219-226, 421-428): None (auto) runs the
SigLIP MLP halves through the fused kernel #9 in `encode_prompt` when the
tower is plain bf16 and leaves it off in `generate_fused`; True / False
force both.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import (DreamGenerationConfig, GenerationConfig, LaViDaConfig,
                      as_port_config, config_from_checkpoint)

from ..generation import diffusion
from ..generation.diffusion import build_control_table, generate_cached_fused
from ..generation.dream_sampler import dream_generate
from ..ops.quant import attach_lora
from ..utils.profiling import span
from . import dream, llada_loader, multimodal, projector, siglip
from .llada import LLaDA, Norm
from .projector import Projector
from .siglip import LayerNorm, SigLIP

SIGLIP_PREFIX = "vision_tower.vision_tower.vision_model."
# the convs kept as Linears: flattened when they are loaded
CONVS = (siglip.PATCH_CONV, "mm_projector.conv_pool.weight")


class _BinFile:
    """A pytorch_model*.bin shard mapped by torch.load(mmap=True); its
    floating tensors read as float32 (lavida.py:51, `v.float()`)."""

    def __init__(self, path: str):
        self.path = path
        self.tensors = torch.load(path, map_location="cpu",
                                  weights_only=True, mmap=True)

    def keys(self):
        return self.tensors.keys()

    def get(self, key: str) -> torch.Tensor:
        t = self.tensors[key]
        return t.float() if t.is_floating_point() else t

    def close(self) -> None:
        self.tensors = {}


class TensorRef:
    """One tensor of a checkpoint file, read when `load()` is called."""

    __slots__ = ("file", "key")

    def __init__(self, file, key: str):
        self.file, self.key = file, key

    def load(self) -> torch.Tensor:
        return self.file.get(self.key)


class LoraMerged:
    """A base weight with a LoRA pair merged in when it is loaded:
    W + scale * (B @ A) in numpy float32, cast back to W's dtype
    (lavida.py:150-152)."""

    __slots__ = ("base", "a", "b", "scale")

    def __init__(self, base, a: torch.Tensor, b: torch.Tensor, scale: float):
        self.base, self.a, self.b, self.scale = base, a, b, scale

    def load(self) -> torch.Tensor:
        w = _read(self.base)
        delta = self.b.float().numpy() @ self.a.float().numpy()
        merged = w.float().numpy() + self.scale * delta
        return torch.from_numpy(merged).to(w.dtype)


def _read(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else v.load()


def close_checkpoint(state: dict) -> None:
    """Close every file the references of `state` read from; tensors
    already taken stay valid."""
    for v in state.values():
        while isinstance(v, LoraMerged):
            v = v.base
        if isinstance(v, TensorRef):
            v.file.close()


def _file_refs(f) -> dict:
    return {k: TensorRef(f, k) for k in f.keys()}


def load_state_shards(path: str) -> dict:
    """{name: TensorRef} over every safetensors shard of `path`, else every
    pytorch_model*.bin shard (lavida.py:38)."""
    from ..tools.safetensors_io import SafetensorsFile

    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    files = ([SafetensorsFile(f) for f in st_files] if st_files else
             [_BinFile(f) for f in sorted(glob.glob(
                 os.path.join(path, "pytorch_model*.bin")))])
    if not files:
        raise FileNotFoundError(f"no checkpoint shards under {path}")
    state: dict = {}
    for f in files:
        state.update(_file_refs(f))
    return state


def _load_torch_bin(path: str) -> dict:
    return _file_refs(_BinFile(path))


def _strip_peft_prefixes(state: dict) -> dict:
    """non_lora_trainables key normalization (builder.py:106-108): drop
    'base_model.' then a further 'model.' when keys start 'model.model.'."""
    state = {(k[len("base_model."):] if k.startswith("base_model.") else k): v
             for k, v in state.items()}
    if any(k.startswith("model.model.") for k in state):
        state = {(k[len("model."):] if k.startswith("model.") else k): v
                 for k, v in state.items()}
    return state


def load_lora_adapter(path: str) -> tuple[dict, float]:
    """A peft adapter directory -> ({name: tensor}, lora_alpha / r)."""
    from ..tools.safetensors_io import load_file

    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    scale = acfg["lora_alpha"] / acfg["r"]
    st = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(st):
        return load_file(st), scale
    refs = _load_torch_bin(os.path.join(path, "adapter_model.bin"))
    return {k: r.load() for k, r in refs.items()}, scale


def merge_lora_state(state: dict, adapter: dict, scale: float) -> dict:
    """peft LoRA pairs merged into the state (the merge_and_unload step of
    builder.py:117-121): `<module>.weight` becomes a `LoraMerged` for each
    `<module>.lora_{A,B}[.default].weight` pair; peft's
    `base_model.model.` / `base_model.` prefixes are resolved against the
    state's names.  The merge runs when the weight is loaded."""
    out = dict(state)
    for k, a in adapter.items():
        if ".lora_A." not in k:
            continue
        b_key = k.replace(".lora_A.", ".lora_B.")
        if b_key not in adapter:
            raise KeyError(f"unpaired LoRA weight: {k}")
        mod = k.split(".lora_A.")[0]
        for pref in ("base_model.model.", "base_model.", ""):
            if mod.startswith(pref) and mod[len(pref):] + ".weight" in out:
                w_key = mod[len(pref):] + ".weight"
                break
        else:
            raise KeyError(f"no base weight for LoRA module {mod}")
        out[w_key] = LoraMerged(out[w_key], a, adapter[b_key], scale)
    return out


def open_checkpoint(path: str, base: Optional[str] = None) -> dict:
    """The state of one of the reference's three load modes (builder.py:
    62-170): `path` alone; `base` overlaid with `path`/mm_projector.bin;
    `base` with `path`'s non_lora_trainables.bin overlaid and its peft
    adapter merged."""
    if base is None:
        return load_state_shards(path)
    state = load_state_shards(base)
    if os.path.exists(os.path.join(path, "adapter_config.json")):
        nlt = os.path.join(path, "non_lora_trainables.bin")
        if os.path.exists(nlt):
            state.update(_strip_peft_prefixes(_load_torch_bin(nlt)))
        adapter, scale = load_lora_adapter(path)
        return merge_lora_state(state, adapter, scale)
    proj_bin = os.path.join(path, "mm_projector.bin")
    if os.path.exists(proj_bin):
        state.update(_load_torch_bin(proj_bin))
        return state
    raise FileNotFoundError(
        f"{path}: expected mm_projector.bin or a peft adapter when base= "
        f"is given (builder.py:62-170 load modes)")


def checkpoint_plan(state, cfg: LaViDaConfig, lm_family: str = "llada"
                    ) -> dict:
    """{LaViDa state-dict name: checkpoint key} for the names of `state`;
    the keys of SigLIP's dropped layers and unused parts are left out, any
    other key that maps nowhere raises.  lm_family "dream": the LM under
    the HF Dream names (models/dream.py)."""
    if lm_family == "dream":
        plan = dream.lm_plan(state, cfg.llada, "llada.")
        lm_keys = set(plan.values())
    else:
        plan = llada_loader.lm_plan(state, cfg.llada, "llada.")
        lm_keys = set()
    for key in state:
        k = key[len("model."):] if key.startswith("model.") else key
        if k.startswith("transformer.") or key in lm_keys:
            continue
        if k == "image_newline":
            llada_loader.plan_put(plan, "image_newline", key)
        elif k.startswith(SIGLIP_PREFIX):
            name = siglip.port_name(k[len(SIGLIP_PREFIX):], cfg.vision.siglip)
            if name is not None:
                llada_loader.plan_put(plan, "siglip." + name, key)
        elif k.startswith("mm_projector."):
            name = projector.port_name(k[len("mm_projector."):],
                                       cfg.vision.projector_type)
            if name is not None:
                llada_loader.plan_put(plan, "projector." + name, key)
        else:
            raise ValueError(f"checkpoint key {key!r} maps to nothing in "
                             f"the port's LaViDa")
    return plan


@torch.no_grad()
def fill_module(module: nn.Module, state: dict, plan: dict,
                optional: Sequence[str] = ()) -> None:
    """Copy `state[plan[name]]` into each parameter `name` of `module`
    (cast to its dtype, on its device), one tensor at a time in the order
    of `state`, each dropped (and unmapped) once copied.  A parameter in `optional`
    that the plan lacks is zeroed; any other missing one raises before
    anything is read.  A weight of another shape raises, except the
    SigLIP patch conv [D, C, p, p] and the pooler projector's conv [O, D,
    r, r], which are flattened to [D, C*p*p] and [O, D*r*r]."""
    params = dict(module.named_parameters())
    unknown = set(plan) - set(params)
    if unknown:
        raise ValueError(f"no parameter {sorted(unknown)[:4]} in the model")
    missing = sorted(set(params) - set(plan) - set(optional))
    if missing:
        raise KeyError(f"the checkpoint has no weight for {len(missing)} "
                       f"parameters, e.g. {missing[:4]}")
    for name in set(optional) - set(plan):
        params[name].zero_()
    by_key = {key: name for name, key in plan.items()}
    for key, ref in state.items():
        name = by_key.get(key)
        if name is None:
            continue
        p, t = params[name], _read(ref)
        if t.shape != p.shape and key.endswith(CONVS) and t.dim() == 4:
            t = t.reshape(t.shape[0], -1)
        if t.shape != p.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, the port's "
                             f"{name} is {tuple(p.shape)}")
        p.copy_(t)
        del t           # unmaps the tensor's bytes


class LaViDa(nn.Module):
    def __init__(self, cfg: LaViDaConfig, device, dtype=None,
                 lm_family: str = "llada"):
        super().__init__()
        if lm_family not in ("llada", "dream"):
            raise ValueError(f"lm_family {lm_family!r}")
        cfg = as_port_config(cfg)
        self.cfg = cfg
        self.lm_family = lm_family
        kw = dict(device=device, dtype=dtype)
        self.llada = LLaDA(cfg.llada, **kw)
        self.siglip = SigLIP(cfg.vision.siglip, **kw)
        self.projector = Projector(cfg.vision.projector_type,
                                   cfg.vision.mm_hidden_size,
                                   cfg.llada.d_model, **kw)
        self.image_newline = nn.Parameter(torch.zeros(cfg.llada.d_model,
                                                      **kw))
        self.use_vision_fused_mlp: Optional[bool] = None

    @property
    def device(self) -> torch.device:
        return self.image_newline.device

    @classmethod
    @torch.no_grad()
    def random_init(cls, cfg: LaViDaConfig, seed: int, dtype: torch.dtype,
                    device, lm_family: str = "llada") -> "LaViDa":
        """Seeded random weights drawn on `device` by a generator there:
        every linear, embedding and position table ~ N(0, 0.02) with zero
        biases, norms at one, the newline ~ N(0, 1/D), as the JAX
        `init_params` draws them (llada.py:47-105)."""
        model = cls(cfg, "meta", dtype, lm_family).to_empty(device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, (Norm, LayerNorm)):
                m.weight.fill_(1.0)
                if isinstance(m, LayerNorm):
                    m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, 0.02, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
        model.siglip.pos_embed.normal_(0.0, 0.02, generator=gen)
        model.image_newline.normal_(0.0, cfg.llada.d_model ** -0.5,
                                    generator=gen)
        return model.eval()

    @classmethod
    def from_jax(cls, cfg: LaViDaConfig, params: dict, device,
                 dtype: Optional[torch.dtype] = None,
                 prefill_params: Optional[dict] = None,
                 lm_family: str = "llada") -> "LaViDa":
        """The model with the JAX package's params (a pytree of numpy
        arrays, LLaDA blocks stacked or unstacked, linears plain, int8 or
        int4) on `device`, its float parameters in the params' dtype unless
        `dtype` is given.  LoRA factors in `params` go onto their linears
        (ops/quant.attach_lora).  `prefill_params`: the JAX model's int8
        prefill tree of the mixed layout (`LaViDa.prefill_params`).  An
        int8 tower (`siglip.quantize_tower`) comes as the port's.  `cfg` is the
        JAX model's config after `to_serving_layout` (the sequential
        block layout when it fused), the JAX dataclass or the port's."""
        from ..convert import prefill_state_from_jax, state_dict_from_jax

        cfg = as_port_config(cfg)

        state = state_dict_from_jax(params)
        if prefill_params is not None:
            state.update(prefill_state_from_jax(prefill_params,
                                                params["llada"]))
        trims = {k[:-len(".__trim__")]: int(state.pop(k))
                 for k in [k for k in state if k.endswith(".__trim__")]}
        model = cls(cfg, "meta", lm_family=lm_family)
        if "res_blocks" not in params.get("projector", {}):
            model.projector.drop_res_blocks()
        model.llada.adopt_layout({k[len("llada."):]: v
                                  for k, v in state.items()
                                  if k.startswith("llada.")})
        if "siglip.layers.0.fc1.weight_q" in state:     # quantize_tower's
            model.siglip.adopt_int8()
        for name, n in trims.items():
            if model.get_submodule(name).out_features != n:
                raise ValueError(f"{name}: __trim_{n}__ disagrees with the "
                                 f"config")
        for k in [k for k in state if k.endswith(".lora_a")]:
            name = k[:-len(".lora_a")]
            attach_lora(model.get_submodule(name), state[k],
                        state[f"{name}.lora_b"], state[f"{name}.lora_scale"])
        model.load_state_dict(state, strict=True, assign=True)
        model.to(device=device)
        if dtype is not None:
            for p in model.parameters():
                p.data = p.data.to(dtype)
        return model.eval()

    @classmethod
    @torch.no_grad()
    def load(cls, path: str, cfg: Optional[LaViDaConfig] = None,
             dtype: torch.dtype = torch.bfloat16,
             lm_family: Optional[str] = None, base: Optional[str] = None,
             device="cuda") -> "LaViDa":
        """A checkpoint directory in one of the reference's three load
        modes (builder.py:62-170, `open_checkpoint`): base=None, the
        full checkpoint under `path`; `base` + `path`/mm_projector.bin,
        the projector overlay; `base` + a peft adapter under `path`,
        non_lora_trainables overlaid and the LoRA pairs merged.  The
        geometry and LM family are sniffed from `path`/config.json when
        not given (the composed config lives with the delta).  Every
        weight streams from the mapped files straight into the model's
        parameters in `dtype` on `device`: on the card the bf16 8B goes
        there directly and `to_serving_layout` quantizes it there.
        lm_family "dream" (lavida.py:63-66): the LM under the HF Dream
        names (models/dream.py)."""
        if cfg is None or lm_family is None:
            scfg, sfam = config_from_checkpoint(path)
            cfg = cfg if cfg is not None else scfg
            lm_family = lm_family or sfam or "llada"
        cfg = as_port_config(cfg) or LaViDaConfig()
        state = open_checkpoint(path, base)
        if lm_family == "dream" and not cfg.llada.include_qkv_bias and any(
                k.endswith("self_attn.q_proj.bias") for k in state):
            # JAX's converter keeps a Dream checkpoint's q/k/v biases
            # whatever the given config says, and its linears add a bias
            # that the params hold (train.py --style dream passes its own
            # geometry, which has none)
            cfg = cfg.replace(llada=cfg.llada.replace(include_qkv_bias=True))
        try:
            model = cls(cfg, "meta", dtype, lm_family)
            model.projector.drop_res_blocks()
            model.to_empty(device=device)
            fill_module(model, state, checkpoint_plan(state, cfg, lm_family),
                        optional=("image_newline",))
        finally:
            close_checkpoint(state)
        return model.eval()

    @torch.no_grad()
    def to_serving_layout(self, quant: str = "mixed",
                          fuse: bool = True) -> "LaViDa":
        """The LM in a serving layout, in place (lavida.py:299-333), the
        weights quantized where they lie and each bf16 linear freed once
        quantized:

          (fuse, int4 or mixed: the sequential layout, `to_fused_layout`)
          -> (mixed: the int8 prefill tree, quantized before the int4
          pass frees the bf16 linears) -> int4 or int8 quantization.

        quant: "mixed" (int8 prefill + int4 decode, bench.py's default),
        "int4", "int8" or "none".  The prefill tree shares the embedding,
        ln_f and the norms with the decode tree.  With fuse=False (the
        worker's choice for --decode-batch > 1) the llama blocks stay
        unfused and every int4 linear runs the grouped W4A8 kernel #4;
        "int8" alone runs weight-only int8 linears (a plain matmul, as
        XLA's in the JAX package)."""
        if quant not in ("mixed", "int4", "int8", "none"):
            raise ValueError(f"quant {quant!r}")
        if quant == "none":
            return self
        if fuse and quant in ("int4", "mixed"):
            self.cfg = self.cfg.replace(llada=self.llada.to_fused_layout())
        if quant == "mixed":
            self.llada.add_prefill_tree()
        self.llada.quantize(4 if quant in ("int4", "mixed") else 8)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self

    def shard(self, tp: int = 1, dp: int = 1, fsdp: int = 1,
              mesh=None) -> "LaViDa":
        """Multi-card bf16 serving (lavida.py:335-360): the parameters
        placed on a (dp, fsdp, tp) mesh by parallel/sharding's col / row
        rules, in place; the same `generate` then runs with each linear
        gathered over fsdp and split over tp, one all-reduce per
        row-parallel linear.  The mesh takes the first dp * fsdp * tp ranks
        of the process group (a `--tp 2` run needs no more).  The float
        llama layout only: the quantized and fused serving layouts have no
        rules (the CLIs refuse --tp with them, as the JAX ones do)."""
        from ..parallel import make_mesh, shard_params

        if self.llada.cfg.block_type != "llama":
            raise ValueError("shard the llama layout: the fused serving "
                             "layout has no sharding rules")
        if mesh is None:
            mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp,
                             devices=range(dp * fsdp * tp),
                             device_type=self.device.type)
        shard_params(self, mesh)
        return self

    @property
    def mixed(self) -> bool:
        """Whether the LM carries the mixed layout's int8 prefill tree."""
        return self.llada.blocks[0].prefill is not None

    def _vision_fused_mlp(self) -> bool:
        """The fused ViT-MLP policy of `encode_prompt`: the explicit
        override, else on for a plain bf16 tower (SigLIP.fused_mlp_ok)."""
        if self.use_vision_fused_mlp is not None:
            return self.use_vision_fused_mlp
        return self.siglip.fused_mlp_ok()

    @torch.no_grad()
    def encode_prompt(self, input_ids: np.ndarray,
                      images: Sequence[np.ndarray] = (),
                      image_sizes: Sequence[tuple[int, int]] = (),
                      image_features: Optional[Sequence[torch.Tensor]] = None,
                      *, row: Optional[int] = None) -> torch.Tensor:
        """One sample: ids with -200 markers and per-image view stacks ->
        spliced prefix embeddings [1, P, D] (lavida.py:430-452), one
        vision encode per image; `image_features` supplies the blocks
        [n_i, D] instead (SHIRG's 980-token selection, models/shirg.py).
        row: the sample's row in its batch, for the `vision.encode` span."""
        with span("vision.encode", row=row):
            if image_features is not None:
                feats = list(image_features)
            else:
                feats = []
                for v, size in zip(images, image_sizes):
                    with span("vision.upload"):
                        views = torch.as_tensor(np.asarray(v),
                                                device=self.device)
                    feats.append(multimodal.encode_image(
                        self, views, size, fused_mlp=self._vision_fused_mlp()))
            with span("vision.merge"):
                embeds = multimodal.splice_embeddings(self, input_ids, feats)
            if self.cfg.tokenizer_model_max_length:
                embeds = embeds[:self.cfg.tokenizer_model_max_length]
            return embeds[None]

    @torch.no_grad()
    def generate(
        self,
        input_ids: np.ndarray,
        images: Sequence[np.ndarray] = (),
        image_sizes: Sequence[tuple[int, int]] = (),
        gen: Optional[GenerationConfig] = None,
        prefix_bucket: Optional[int] = None,
        kv8: bool | int = False,
        generator: Optional[torch.Generator] = None,
        tokens_hook=None,
        logits_hook=None,
        draft_tokens=None,
        image_features: Optional[Sequence[torch.Tensor]] = None,
    ) -> np.ndarray:
        """One sample through `encode_prompt` (with `image_features`, the
        given blocks in place of the encodes: `predict --shirg`) and
        `diffusion.generate`
        (lavida.py:454-531, the LLaDA sampler): the prefix front-padded to
        a multiple of prefix_bucket with the pad rows masked; in the mixed
        layout the int8 tree prefills.  Every branch of `generate` by
        `gen`: the prefix cache, or none (gen.prefix_lm False; refused in
        the mixed layout, as the JAX package refuses it).  draft_tokens: a
        [Td] FIM skeleton (Td <= G) written into the head of the answer,
        its mask-id holes denoised (predict_fim.py).  Returns the [G]
        generated ids.

        With a `DreamGenerationConfig`, the Dream sampler instead
        (lavida.py:500-512): no prefix bucket, dense attention, the hooks
        (generation_utils.py:308-309) forwarded, and in the mixed layout
        the int8 tree prefills unless a hook is given (the hooked loop
        prefills with the decode linears)."""
        gen = as_port_config(gen) or GenerationConfig()
        prefix = self.encode_prompt(input_ids, images, image_sizes,
                                    image_features)
        prefix_valid = None
        if prefix_bucket:
            P = prefix.shape[1]
            Pb = -(-P // prefix_bucket) * prefix_bucket
            if Pb > P:
                prefix = torch.cat([prefix.new_zeros(1, Pb - P,
                                                     prefix.shape[-1]),
                                    prefix], dim=1)
                prefix_valid = torch.arange(Pb, device=self.device)[None] \
                    >= Pb - P
        if isinstance(gen, DreamGenerationConfig):
            if prefix_valid is not None:
                raise NotImplementedError(
                    "prefix bucketing for the Dream sampler is not wired "
                    "(as in the JAX package)")
            mixed = self.mixed and tokens_hook is None \
                and logits_hook is None
            out = dream_generate(
                self.llada, prefix, gen, generator=generator,
                tokens_hook=tokens_hook, logits_hook=logits_hook,
                act_int8_prefill=mixed)
            return out[0].cpu().numpy()
        if tokens_hook is not None or logits_hook is not None:
            raise ValueError("generation hooks are a Dream-sampler surface "
                             "(generation_utils.py:308-309)")
        out = diffusion.generate(
            self.llada, prefix, gen, prefix_valid=prefix_valid,
            generator=generator, act_int8_prefill=self.mixed, kv8=kv8,
            draft_tokens=(None if draft_tokens is None
                          else np.asarray(draft_tokens)[None]))
        return out[0].cpu().numpy()

    @torch.no_grad()
    def generate_fused(
        self,
        input_ids: np.ndarray,
        images: Sequence[np.ndarray] = (),
        image_sizes: Sequence[tuple[int, int]] = (),
        gen: Optional[GenerationConfig] = None,
        prefix_bucket: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        kv8: bool | int = False,
    ) -> np.ndarray:
        """One sample: ids with -200 image markers, one [V, C, S, S] view
        stack and one (width, height) size per image.  Returns the [G]
        generated ids.

        prefix_bucket: front-pad the splice plan to a multiple of this
        length (the pad rows are masked out), as the JAX path does to
        reuse compiled executables; the tokens do not change.
        generator: the randomness of temperature > 0 or random remasking
        (default: seed 0 on the model's device).  kv8: decode over the
        int8 KV cache (True) or the int4 one (4)."""
        gen = as_port_config(gen) or GenerationConfig()
        if not gen.prefix_lm:
            raise NotImplementedError("generate_fused implements the "
                                      "prefix-cache mode only")
        cfg, device = self.cfg, self.device
        ids = np.asarray(input_ids)
        n_views = [[v.shape[0] for v in images]]
        plan = dict(batch_input_ids=[ids], batch_n_views=n_views,
                    batch_image_sizes=[list(image_sizes)])
        gather_idx, text_ids, valid, _ = multimodal.build_gather_plan(
            cfg, **plan)
        prefix_valid = None
        if prefix_bucket:
            P = gather_idx.shape[1]
            Pb = -(-P // prefix_bucket) * prefix_bucket
            if Pb > P:
                gather_idx, text_ids, valid, _ = multimodal.build_gather_plan(
                    cfg, **plan, pad_to=Pb, pad_front=True)
                prefix_valid = torch.as_tensor(valid, device=device)
        G = gen.max_new_tokens
        mask_id = cfg.llada.mask_token_id
        k_table, block_end = build_control_table(
            np.full((1, G), mask_id, np.int64), 0, G, gen, mask_id)
        S = cfg.vision.siglip.image_size
        pix = (torch.cat([torch.as_tensor(np.asarray(v)) for v in images])
               if images else torch.zeros((0, 3, S, S)))
        prefix = multimodal.multimodal_embeds(
            self, pix.to(device), text_ids, gather_idx,
            fused_mlp=self.use_vision_fused_mlp is True)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        x = torch.full((1, G), mask_id, dtype=torch.long, device=device)
        out = generate_cached_fused(
            self.llada, x, prefix, torch.as_tensor(k_table, device=device),
            torch.as_tensor(block_end, device=device), prefix_valid,
            generator, gen.temperature, gen.remasking,
            act_int8_prefill=self.mixed, kv8=kv8)
        return out[0].cpu().numpy()

    def decode_output(self, ids, tokenizer,
                      stop_ids: Optional[Sequence[int]] = None) -> str:
        """Cut at EOS or the conversation's stop ids (e.g. 126348 for
        llada) and decode without the special tokens (lavida.py:603)."""
        ids = [int(i) for i in np.asarray(ids)]
        cut = len(ids)
        for s in {self.cfg.llada.eos_token_id, *(stop_ids or ())}:
            if s in ids:
                cut = min(cut, ids.index(s))
        return tokenizer.decode(ids[:cut], skip_special_tokens=True).strip()
