"""Typed configuration tree of the port: a copy of the model and generation
configs of lavida_mod_tpu/config.py (LLaDAConfig, SigLIPConfig,
VisionConfig, LaViDaConfig, GenerationConfig, the tiny fixtures and the
default anyres pinpoints), so the port imports nothing of the JAX package.
tests/test_torch_config.py holds every default equal to the original, field
for field.

`as_port_config` turns an instance of the JAX package's dataclass of the
same name (anything with the same fields) into the port's, recursively and
by field name, without importing it: the port's entry points accept either.
"""

from __future__ import annotations

import dataclasses
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


_CLASSES = {c.__name__: c for c in (LLaDAConfig, SigLIPConfig, VisionConfig,
                                    LaViDaConfig, GenerationConfig)}


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
