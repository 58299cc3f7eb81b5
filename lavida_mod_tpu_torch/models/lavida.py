"""LaViDa: the composed multimodal masked-diffusion model, ported from
lavida_mod_tpu/models/lavida.py for the single-image serving slice.

An nn.Module holding the LLaDA LM, the SigLIP tower, the projector and the
image-newline vector, with the entry points:
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
    image and the splice by concatenation, then `diffusion.generate`
    with optional front-padding to a bucket and the int8 KV cache.
`use_vision_fused_mlp` (lavida.py:219-226, 421-428): None (auto) runs the
SigLIP MLP halves through the fused kernel #9 in `encode_prompt` when the
tower is plain bf16 and leaves it off in `generate_fused`; True / False
force both.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import GenerationConfig, LaViDaConfig, as_port_config

from ..generation import diffusion
from ..generation.diffusion import build_control_table, generate_cached_fused
from . import multimodal
from .llada import LLaDA, RMSNorm
from .projector import Projector
from .siglip import LayerNorm, SigLIP


class LaViDa(nn.Module):
    def __init__(self, cfg: LaViDaConfig, device, dtype=None):
        super().__init__()
        cfg = as_port_config(cfg)
        self.cfg = cfg
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
                    device) -> "LaViDa":
        """Seeded random weights drawn on `device` by a generator there:
        every linear, embedding and position table ~ N(0, 0.02) with zero
        biases, norms at one, the newline ~ N(0, 1/D), as the JAX
        `init_params` draws them (llada.py:47-105)."""
        model = cls(cfg, "meta", dtype).to_empty(device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, (RMSNorm, LayerNorm)):
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
                 prefill_params: Optional[dict] = None) -> "LaViDa":
        """The model with the JAX package's params (a pytree of numpy
        arrays, LLaDA blocks stacked or unstacked, linears plain, int8 or
        int4) on `device`, its float parameters in the params' dtype unless
        `dtype` is given.  `prefill_params`: the JAX model's int8 prefill
        tree of the mixed layout (`LaViDa.prefill_params`).  `cfg` is the
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
        model = cls(cfg, "meta")
        model.llada.adopt_layout({k[len("llada."):]: v
                                  for k, v in state.items()
                                  if k.startswith("llada.")})
        for name, n in trims.items():
            if model.get_submodule(name).out_features != n:
                raise ValueError(f"{name}: __trim_{n}__ disagrees with the "
                                 f"config")
        model.load_state_dict(state, strict=True, assign=True)
        model.to(device=device)
        if dtype is not None:
            for p in model.parameters():
                p.data = p.data.to(dtype)
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
                      image_sizes: Sequence[tuple[int, int]] = ()
                      ) -> torch.Tensor:
        """One sample: ids with -200 markers and per-image view stacks ->
        spliced prefix embeddings [1, P, D] (lavida.py:430-452), one
        vision encode per image."""
        device = self.device
        feats = [multimodal.encode_image(
            self, torch.as_tensor(np.asarray(v), device=device), size,
            fused_mlp=self._vision_fused_mlp())
            for v, size in zip(images, image_sizes)]
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
        kv8: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> np.ndarray:
        """One sample through `encode_prompt` and `diffusion.generate`
        (lavida.py:454-531, the LLaDA sampler): the prefix front-padded to
        a multiple of prefix_bucket with the pad rows masked; in the mixed
        layout the int8 tree prefills.  Returns the [G] generated ids."""
        gen = as_port_config(gen) or GenerationConfig()
        prefix = self.encode_prompt(input_ids, images, image_sizes)
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
        out = diffusion.generate(
            self.llada, prefix, gen, prefix_valid=prefix_valid,
            generator=generator, act_int8_prefill=self.mixed, kv8=kv8)
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
        kv8: bool = False,
    ) -> np.ndarray:
        """One sample: ids with -200 image markers, one [V, C, S, S] view
        stack and one (width, height) size per image.  Returns the [G]
        generated ids.

        prefix_bucket: front-pad the splice plan to a multiple of this
        length (the pad rows are masked out), as the JAX path does to
        reuse compiled executables; the tokens do not change.
        generator: the randomness of temperature > 0 or random remasking
        (default: seed 0 on the model's device).  kv8: decode over the
        int8 KV cache."""
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
