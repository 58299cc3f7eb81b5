"""Typed configuration tree of the port: a copy of the model and generation
configs of lavida_mod_tpu/config.py (LLaDAConfig, SigLIPConfig,
VisionConfig, LaViDaConfig, GenerationConfig, DreamGenerationConfig, the
tiny fixtures and the default anyres pinpoints), and of the two configs
that the JAX package keeps beside their models (EVAConfig,
models/eva_clip.py:40-68; QformerConfig, models/qformer.py:35-43), so the
port imports nothing of the JAX package.
tests/test_torch_config.py holds every default equal to the original, field
for field.

`config_from_checkpoint(path)` sniffs (LaViDaConfig, lm_family) from a
checkpoint directory's config.json (config.py:208-320): the flat OLMo-style
LLaDA fields, Qwen2-style Dream fields over `dream_7b_config` (the Dream
geometry of models/dream.py:32) and the LLaVA composition fields.

`as_port_config` turns an instance of the JAX package's dataclass of the
same name (anything with the same fields) into the port's, recursively and
by field name, without importing it: the port's entry points accept either.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LLaDAConfig:
    """Bidirectional (non-causal) diffusion-LM transformer config; the
    defaults are the LLaDA-8B geometry LaViDa uses (llama block layout:
    separate q/k/v, SwiGLU via ff_proj/up_proj, RMSNorm, RoPE)."""

    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: Optional[int] = None          # None => n_heads (MHA)
    n_layers: int = 32
    mlp_hidden_size: Optional[int] = 12288    # None => mlp_ratio * d_model
    mlp_ratio: int = 4
    block_type: str = "llama"                 # llama | sequential
    activation: str = "silu"                  # gelu|relu|silu|swiglu
    rope: bool = True
    rope_theta: float = 500000.0
    rope_full_precision: bool = True
    layer_norm_type: str = "rms"              # rms|default|gemma_rms
    rms_norm_eps: float = 1e-5
    layer_norm_eps: float = 1e-5
    attention_layer_norm: bool = False
    layer_norm_with_affine: bool = True
    attention_layer_norm_with_affine: bool = True
    include_bias: bool = False
    include_qkv_bias: bool = False
    input_emb_norm: bool = False
    scale_logits: bool = False
    vocab_size: int = 126464
    embedding_size: Optional[int] = 126464
    weight_tying: bool = False
    max_sequence_length: int = 4096
    mask_token_id: int = 126336
    eos_token_id: int = 126081
    pad_token_id: int = 126081

    @property
    def effective_n_kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def hidden_size(self) -> int:
        return (self.mlp_hidden_size if self.mlp_hidden_size is not None
                else self.mlp_ratio * self.d_model)

    @property
    def num_embeddings(self) -> int:
        return self.embedding_size or self.vocab_size

    def replace(self, **kw) -> "LLaDAConfig":
        return dataclasses.replace(self, **kw)


def tiny_llada_config(**kw) -> LLaDAConfig:
    """The 2-layer test fixture."""
    base = dict(d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                mlp_hidden_size=128, vocab_size=512, embedding_size=512,
                rope_theta=10000.0, max_sequence_length=512,
                mask_token_id=500, eos_token_id=501, pad_token_id=501)
    base.update(kw)
    return LLaDAConfig(**base)


@dataclass(frozen=True)
class SigLIPConfig:
    """SigLIP ViT config, no CLS token; `n_layers_used` drops the final
    encoder layer, as the LaViDa tower does."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    drop_last_layer: bool = True

    @property
    def n_layers_used(self) -> int:
        return self.num_hidden_layers - (1 if self.drop_last_layer else 0)

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "SigLIPConfig":
        return dataclasses.replace(self, **kw)


def tiny_siglip_config(**kw) -> SigLIPConfig:
    base = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                num_attention_heads=4, image_size=56, patch_size=14)
    base.update(kw)
    return SigLIPConfig(**base)


# LaViDa-HD anyres grid pinpoints
DEFAULT_GRID_PINPOINTS: Tuple[Tuple[int, int], ...] = (
    (384, 768), (768, 384), (768, 768), (1152, 384), (384, 1152))


@dataclass(frozen=True)
class VisionConfig:
    """Multimodal composition knobs."""

    siglip: SigLIPConfig = SigLIPConfig()
    projector_type: str = "mlp2x_gelu"
    mm_hidden_size: int = 1152
    spatial_pool_mode: str = "bilinear"       # average|max|bilinear
    spatial_pool_stride: int = 2
    image_aspect_ratio: str = "anyres"
    grid_pinpoints: Tuple[Tuple[int, int], ...] = DEFAULT_GRID_PINPOINTS
    mm_patch_merge_type: str = "spatial_unpad"
    mm_newline_position: str = "one_token"

    def replace(self, **kw) -> "VisionConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LaViDaConfig:
    """The composed multimodal model."""

    llada: LLaDAConfig = LLaDAConfig()
    vision: VisionConfig = VisionConfig()
    tokenizer_model_max_length: Optional[int] = None
    train_seq_cutoff: int = 30720

    def replace(self, **kw) -> "LaViDaConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GenerationConfig:
    """Masked-diffusion sampling knobs."""

    max_new_tokens: int = 128
    block_length: int = 128
    steps: Optional[int] = None               # defaults to max_new_tokens
    step_per_block: Optional[int] = None
    step_ratio: Optional[float] = None
    temperature: float = 0.0
    remasking: str = "low_confidence"         # |random|entrophy|margin
    schedule: Optional[str] = None            # linear|cosine|logit_normal|shift
    schedule_shift: float = 3.0
    prefix_lm: bool = True                    # use the prefix KV cache

    def replace(self, **kw) -> "GenerationConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DreamGenerationConfig:
    """Dream sampler knobs (dream/generation_utils.py:99-147)."""

    max_new_tokens: int = 128
    steps: int = 512                    # clamped to max_new_tokens
    eps: float = 1e-3
    alg: str = "origin"                 # origin|maskgit_plus|topk_margin|entropy
    alg_temp: Optional[float] = None
    temperature: float = 0.0
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    schedule: Optional[str] = None
    schedule_shift: float = 3.0
    step_ratio: Optional[float] = None
    prefix_lm: bool = True

    def replace(self, **kw) -> "DreamGenerationConfig":
        return dataclasses.replace(self, **kw)


def dream_7b_config(**kw) -> LLaDAConfig:
    """Dream-v0-7B (Qwen2.5-7B geometry; token ids of
    configuration_dream.py:49-50)."""
    base = dict(
        d_model=3584, n_heads=28, n_kv_heads=4, n_layers=28,
        mlp_hidden_size=18944, block_type="llama", activation="silu",
        rope=True, rope_theta=1000000.0, layer_norm_type="rms",
        rms_norm_eps=1e-6, include_qkv_bias=True, vocab_size=151936,
        embedding_size=151936, weight_tying=False, max_sequence_length=4096,
        mask_token_id=151666, eos_token_id=151643, pad_token_id=151643)
    base.update(kw)
    return LLaDAConfig(**base)


@dataclass(frozen=True)
class EVAConfig:
    """EVA-CLIP vision tower (models/eva_clip.py; eva_vit.py:501-856); the
    defaults are EVA-CLIP-8B's geometry."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 4096
    layers: int = 32
    head_width: int = 128
    mlp_ratio: float = 5.0
    qkv_bias: bool = False
    subln: bool = False
    naiveswiglu: bool = False
    rope: bool = False
    postnorm: bool = False
    ls_init_value: Optional[float] = None
    layer_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pt_hw_seq_len: int = 16

    @property
    def n_heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)

    def replace(self, **kw) -> "EVAConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class QformerConfig:
    """BLIP-2 Q-Former resampler (models/qformer.py): bert-base geometry,
    cross-attention every `cross_attention_freq` layers."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    encoder_width: int = 1152          # vision feature dim
    num_query_tokens: int = 32
    cross_attention_freq: int = 2

    def replace(self, **kw) -> "QformerConfig":
        return dataclasses.replace(self, **kw)


def _sniff_llada(cj: dict) -> LLaDAConfig:
    """Flat OLMo-style fields (configuration_llada.py:130-384 ModelConfig,
    serialized flat by the HF LLaDAConfig wrapper :398-414)."""
    kw = {}
    for f in (
        "d_model", "n_heads", "n_kv_heads", "n_layers", "mlp_hidden_size",
        "mlp_ratio", "rope", "rope_theta", "rope_full_precision",
        "rms_norm_eps", "attention_layer_norm", "layer_norm_with_affine",
        "attention_layer_norm_with_affine", "include_bias",
        "include_qkv_bias", "input_emb_norm", "scale_logits", "vocab_size",
        "embedding_size", "weight_tying", "max_sequence_length",
        "mask_token_id", "eos_token_id", "pad_token_id",
    ):
        if cj.get(f) is not None:
            kw[f] = cj[f]
    if cj.get("activation_type") in ("gelu", "relu", "silu", "swiglu"):
        kw["activation"] = cj["activation_type"]
    if cj.get("block_type") in ("llama", "sequential"):
        kw["block_type"] = cj["block_type"]
    lnt = cj.get("layer_norm_type")
    if isinstance(lnt, str):
        kw["layer_norm_type"] = ("gemma_rms" if "gemma" in lnt
                                 else "rms" if "rms" in lnt else "default")
    return LLaDAConfig(**kw)


def _sniff_dream(cj: dict) -> LLaDAConfig:
    """Qwen2-style fields (dream/configuration_dream.py:28-86)."""
    kw = {}
    for src, dst in (
        ("hidden_size", "d_model"), ("num_attention_heads", "n_heads"),
        ("num_key_value_heads", "n_kv_heads"),
        ("num_hidden_layers", "n_layers"),
        ("intermediate_size", "mlp_hidden_size"),
        ("rope_theta", "rope_theta"), ("rms_norm_eps", "rms_norm_eps"),
        ("vocab_size", "vocab_size"),
        ("max_position_embeddings", "max_sequence_length"),
        ("tie_word_embeddings", "weight_tying"),
        ("mask_token_id", "mask_token_id"),
        ("eos_token_id", "eos_token_id"), ("pad_token_id", "pad_token_id"),
    ):
        if cj.get(src) is not None:
            kw[dst] = cj[src]
    if "vocab_size" in kw:
        kw.setdefault("embedding_size", kw["vocab_size"])
    return dream_7b_config(**kw)


def _sniff_vision(cj: dict) -> VisionConfig:
    """LLaVA composition fields the trainer writes onto the composed HF
    config (llava_arch.py:42-110; train.py's mm_spatial_pool_* and
    image_grid_pinpoints); a nested vision_tower_config dict gives the
    tower's geometry."""
    kw = {}
    for src, dst in (
        ("mm_projector_type", "projector_type"),
        ("mm_hidden_size", "mm_hidden_size"),
        ("mm_spatial_pool_mode", "spatial_pool_mode"),
        ("mm_spatial_pool_stride", "spatial_pool_stride"),
        ("image_aspect_ratio", "image_aspect_ratio"),
        ("mm_patch_merge_type", "mm_patch_merge_type"),
        ("mm_newline_position", "mm_newline_position"),
    ):
        if cj.get(src) is not None:
            kw[dst] = cj[src]
    gp = cj.get("image_grid_pinpoints")
    if isinstance(gp, str):  # mm_utils.py accepts the stringified form
        gp = ast.literal_eval(gp)
    if gp:
        kw["grid_pinpoints"] = tuple(tuple(int(v) for v in p) for p in gp)
    vt = cj.get("vision_tower_config")
    if isinstance(vt, dict):
        names = {f.name for f in dataclasses.fields(SigLIPConfig)}
        kw["siglip"] = SigLIPConfig(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in vt.items() if k in names})
    return VisionConfig(**kw)


def config_from_checkpoint(path: str):
    """(LaViDaConfig, lm_family) sniffed from `path`/config.json, the
    reference builder's AutoConfig.from_pretrained step (builder.py:
    128-146); (None, None) when the directory has no config.json."""
    cfile = os.path.join(path, "config.json")
    if not os.path.exists(cfile):
        return None, None
    with open(cfile) as f:
        cj = json.load(f)
    mt = str(cj.get("model_type", "")).lower()
    if "dream" in mt or ("hidden_size" in cj and "d_model" not in cj
                         and "num_attention_heads" in cj):
        lm_family, lm = "dream", _sniff_dream(cj)
    else:
        lm_family, lm = "llada", _sniff_llada(cj)
    cfg = LaViDaConfig(
        llada=lm, vision=_sniff_vision(cj),
        tokenizer_model_max_length=cj.get("tokenizer_model_max_length"))
    return cfg, lm_family


_CLASSES = {c.__name__: c for c in (LLaDAConfig, SigLIPConfig, VisionConfig,
                                    LaViDaConfig, GenerationConfig,
                                    DreamGenerationConfig, EVAConfig,
                                    QformerConfig)}


def as_port_config(cfg):
    """The port's config equal to `cfg` field for field: `cfg` itself when
    it is one already (or None), else a new instance of the port's
    dataclass of the same class name, nested configs converted too."""
    if cfg is None or type(cfg) in _CLASSES.values():
        return cfg
    cls = _CLASSES.get(type(cfg).__name__)
    if cls is None or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"not a config the port knows: {type(cfg)!r}")
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        kw[f.name] = (as_port_config(v) if dataclasses.is_dataclass(v)
                      else v)
    return cls(**kw)
