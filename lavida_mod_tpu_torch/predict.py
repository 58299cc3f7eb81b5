"""Single-image prediction CLI of the port: the counterpart of the repo's
predict.py, reduced to the slice (random weights; no checkpoint loading or
tokenizer yet, so the prompt is synthetic ids and the output is ids).

Usage:
  python -m lavida_mod_tpu_torch.predict [--tiny] [--mixed] [--image PATH]
      [--max-new-tokens 32] [--step-per-block 16] [--seed 0]
      [--device cuda]

Without --tiny the full LaViDaConfig() geometry (LLaDA-8B + SigLIP so400m)
is initialised on the device from --seed, in bf16.  --mixed then quantizes
the LM there into the mixed serving layout (int8 prefill tree + fused int4
decode tree, bench.py's default; the repo's predict.py --mixed); with
--tiny it takes a 512-wide toy LM whose widths engage the fused plan.  --image goes through
lavida_mod_tpu.data's anyres preprocessing (needs PIL); without it the
views are seeded numpy pixels of a 640x640 image (100x60 with --tiny).
Prints the generated token ids and the latency of one request, timed
after a warm-up request.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def tiny_config():
    """The 2-layer toy geometry of the tests (tests/test_bucketing.py)."""
    from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                       tiny_llada_config, tiny_siglip_config)

    return LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                            grid_pinpoints=((56, 112), (112, 56),
                                            (112, 112))))


def tiny_mixed_config():
    """`tiny_config` with an LM whose every linear width is a multiple of
    512, so the mixed layout's fused decode plan and head engage."""
    from lavida_mod_tpu.config import tiny_llada_config

    return tiny_config().replace(llada=tiny_llada_config(
        d_model=512, n_heads=4, n_kv_heads=4, mlp_hidden_size=1024))


def _views(args, cfg, rng):
    """(views [V, C, S, S] float32, (width, height)) of the one image."""
    if args.image:
        from PIL import Image

        from lavida_mod_tpu.data import SigLIPImageProcessor, process_images

        img = Image.open(args.image)
        proc = SigLIPImageProcessor(size=cfg.vision.siglip.image_size)
        return process_images([img], proc, cfg.vision)[0], img.size
    from lavida_mod_tpu.data.anyres import anyres_grid_shape

    size = (100, 60) if args.tiny else (640, 640)
    S = cfg.vision.siglip.image_size
    nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, S)
    views = rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(np.float32)
    return views, size


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer toy geometry instead of LaViDaConfig()")
    ap.add_argument("--mixed", action="store_true",
                    help="serve the mixed int8-prefill / int4-decode layout")
    ap.add_argument("--image", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--step-per-block", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lavida_mod_tpu.config import GenerationConfig, LaViDaConfig

    from .models.lavida import LaViDa

    device = torch.device(args.device)
    if args.tiny:
        cfg = tiny_mixed_config() if args.mixed else tiny_config()
    else:
        cfg = LaViDaConfig()
    model = LaViDa.random_init(cfg, args.seed, torch.bfloat16, device)
    if args.mixed:
        model.to_serving_layout("mixed", fuse=True)
    rng = np.random.default_rng(args.seed)
    views, size = _views(args, cfg, rng)
    text = rng.integers(3, min(cfg.llada.vocab_size, 30000), size=24)
    ids = np.concatenate([text[:4], [-200], text[4:]])
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        block_length=min(128, args.max_new_tokens),
        step_per_block=args.step_per_block)

    def run():
        out = model.generate_fused(ids, [views], [size], gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    run()
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[predict] layout: {'mixed' if args.mixed else 'bf16'}")
    print("[predict] output ids:", out.tolist())
    print(f"[predict] latency: {dt:.3f}s on {where} (image {size}, "
          f"{views.shape[0]} views, len={args.max_new_tokens})")


if __name__ == "__main__":
    main()
