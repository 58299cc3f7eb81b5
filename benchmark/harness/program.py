"""What the harness takes from the program under test
(`lavida_mod_tpu_torch`, the PyTorch and CUDA port): its configuration
types, the model built on the device and filled with the harness's seeded
leaves, and its launch counters.  Nothing here imports JAX or the JAX
package."""

from __future__ import annotations

import torch

from harness.weights import fill_module

_LLADA_KEYS = (
    "d_model", "n_heads", "n_kv_heads", "n_layers", "mlp_hidden_size",
    "mlp_ratio", "rope", "rope_theta", "rope_full_precision", "rms_norm_eps",
    "include_bias", "include_qkv_bias", "vocab_size", "embedding_size",
    "weight_tying", "max_sequence_length", "mask_token_id", "eos_token_id",
    "pad_token_id", "block_type", "layer_norm_type", "attention_layer_norm",
    "input_emb_norm", "scale_logits")
_DREAM_KEYS = {
    "hidden_size": "d_model", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "num_hidden_layers": "n_layers",
    "intermediate_size": "mlp_hidden_size", "rope_theta": "rope_theta",
    "rms_norm_eps": "rms_norm_eps", "vocab_size": "vocab_size",
    "max_position_embeddings": "max_sequence_length",
    "tie_word_embeddings": "weight_tying", "mask_token_id": "mask_token_id",
    "eos_token_id": "eos_token_id", "pad_token_id": "pad_token_id"}


def port_config(conf: dict):
    """The port's LaViDaConfig for a configuration file."""
    from lavida_mod_tpu_torch.config import (LaViDaConfig, LLaDAConfig,
                                             SigLIPConfig, VisionConfig,
                                             dream_7b_config)

    if conf["family"] == "llada":
        kw = {k: conf[k] for k in _LLADA_KEYS if k in conf}
        kw["activation"] = conf["activation_type"]
        lm = LLaDAConfig(**kw)
    else:
        kw = {dst: conf[src] for src, dst in _DREAM_KEYS.items()}
        kw["embedding_size"] = kw["vocab_size"]
        lm = dream_7b_config(**kw)
    v, c = conf["vision"], conf["composition"]
    sig = SigLIPConfig(**{k: v[k] for k in (
        "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_channels", "image_size", "patch_size",
        "layer_norm_eps", "hidden_act")},
        drop_last_layer=c["mm_vision_select_layer"] == -2)
    vis = VisionConfig(
        siglip=sig, projector_type=c["mm_projector_type"],
        mm_hidden_size=c["mm_hidden_size"],
        spatial_pool_mode=c["mm_spatial_pool_mode"],
        spatial_pool_stride=c["mm_spatial_pool_stride"],
        image_aspect_ratio=c["image_aspect_ratio"],
        grid_pinpoints=tuple(tuple(p) for p in c["image_grid_pinpoints"]),
        mm_patch_merge_type=c["mm_patch_merge_type"],
        mm_newline_position=c["mm_newline_position"])
    return LaViDaConfig(llada=lm, vision=vis)


def build_model(conf: dict, shapes: dict, seed: int, device):
    """LaViDa in bf16 on `device`, every leaf the harness's seeded value.
    Its parameters must be exactly the configuration's leaves."""
    from lavida_mod_tpu_torch.models.lavida import LaViDa

    model = LaViDa(port_config(conf), "meta", torch.bfloat16,
                   conf["family"]).to_empty(device=device)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if got != {n: tuple(s) for n, s in shapes.items()}:
        raise RuntimeError(f"the program's leaves differ from the "
                           f"configuration's: {sorted(set(got) ^ set(shapes))[:8]}")
    fill_module(model, seed)
    return model.eval()


def build_kernels() -> float:
    """The program's CUDA library, built into its checkout on first use
    (nvcc) and loaded; returns the seconds that took."""
    import time

    from lavida_mod_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    return time.perf_counter() - t0


def counters() -> dict:
    """The kernel wrappers' launch counters, by name."""
    from lavida_mod_tpu_torch.ops import prefix_flash as pf
    from lavida_mod_tpu_torch.ops import w4_grouped as wg
    from lavida_mod_tpu_torch.ops.short_attention import short_attention
    from lavida_mod_tpu_torch.ops.vit_mlp import fused_vit_mlp

    g = wg.w4_matmul_grouped
    return {"w4_grouped": g.launches,
            "w4_grouped.prefill": g.prefill_launches,
            "w4_grouped.decode": g.decode_launches,
            "short_attention": short_attention.launches,
            "vit_mlp": fused_vit_mlp.launches,
            "prefix_flash.fwd": pf.prefix_flash_fwd.launches,
            "prefix_flash.dq": pf.prefix_flash_dq.launches,
            "prefix_flash.dkv": pf.prefix_flash_dkv.launches}
