"""Single-image prediction CLI of the port: the counterpart of the repo's
predict.py, reduced to the slice (random weights; no checkpoint loading or
tokenizer yet, so the prompt is synthetic ids and the output is ids).

Usage:
  python -m lavida_mod_tpu_torch.predict [--tiny] [--mixed | --int4]
      [--kv8] [--batch N] [--image PATH] [--max-new-tokens 32]
      [--step-per-block 16] [--seed 0] [--device cuda]

Without --tiny the full LaViDaConfig() geometry (LLaDA-8B + SigLIP so400m)
is initialised on the device from --seed, in bf16.  --mixed then quantizes
the LM there into the mixed serving layout (int8 prefill tree + fused int4
decode tree, bench.py's default; the repo's predict.py --mixed); --int4
into the single grouped-int4 tree, fused for one request of 32 or fewer
tokens and unfused for a batch (the serve worker's --int4 [--decode-batch
N]).  With --tiny the LM is a 512-wide toy whose widths engage the fused
plan.  --kv8 decodes over the int8 KV cache.  --batch N serves N requests
of different image sizes in one batch (eval.adapter.generate_batch, the
worker's --decode-batch N path) instead of one request through
generate_fused.  --image goes through the anyres preprocessing of
lavida_mod_tpu_torch.data (needs PIL) for every request; without it the
views are seeded numpy pixels (a 640x640 image, 100x60 with --tiny, and
other sizes for the rest of a batch).  Prints the generated token ids and
the latency, timed after a warm-up run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def tiny_config():
    """The 2-layer toy geometry of the tests (tests/test_bucketing.py)."""
    from .config import (LaViDaConfig, VisionConfig, tiny_llada_config,
                         tiny_siglip_config)

    return LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                            grid_pinpoints=((56, 112), (112, 56),
                                            (112, 112))))


def tiny_mixed_config():
    """`tiny_config` with an LM whose every linear width is a multiple of
    512, so the mixed layout's fused decode plan and head engage."""
    from .config import tiny_llada_config

    return tiny_config().replace(llada=tiny_llada_config(
        d_model=512, n_heads=4, n_kv_heads=4, mlp_hidden_size=1024))


# image sizes of the requests of a batch (the first is the single request's)
SIZES = [(640, 640), (800, 600), (1024, 512), (448, 896), (1100, 380),
         (512, 1024), (384, 384), (900, 700)]
TINY_SIZES = [(100, 60), (60, 100), (112, 112), (50, 50), (120, 40)]


def _views(args, cfg, rng, i=0):
    """(views [V, C, S, S] float32, (width, height)) of request i's image."""
    if args.image:
        from PIL import Image

        from .data import SigLIPImageProcessor, process_images

        img = Image.open(args.image)
        proc = SigLIPImageProcessor(size=cfg.vision.siglip.image_size)
        return process_images([img], proc, cfg.vision)[0], img.size
    from .data.anyres import anyres_grid_shape

    sizes = TINY_SIZES if args.tiny else SIZES
    size = sizes[i % len(sizes)]
    S = cfg.vision.siglip.image_size
    nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, S)
    views = rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(np.float32)
    return views, size


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer toy geometry instead of LaViDaConfig()")
    layout = ap.add_mutually_exclusive_group()
    layout.add_argument("--mixed", action="store_true",
                        help="serve the mixed int8-prefill / int4-decode "
                        "layout")
    layout.add_argument("--int4", action="store_true",
                        help="serve the grouped-int4 layout")
    ap.add_argument("--kv8", action="store_true",
                    help="decode over the int8 KV cache")
    ap.add_argument("--batch", type=int, default=1,
                    help="requests served together (generate_batch)")
    ap.add_argument("--image", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--step-per-block", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .config import GenerationConfig, LaViDaConfig
    from .models.lavida import LaViDa

    from .eval.adapter import generate_batch

    device = torch.device(args.device)
    if args.tiny:
        cfg = (tiny_mixed_config() if args.mixed or args.int4
               else tiny_config())
    else:
        cfg = LaViDaConfig()
    model = LaViDa.random_init(cfg, args.seed, torch.bfloat16, device)
    layout = "mixed" if args.mixed else "int4" if args.int4 else "bf16"
    if args.mixed:
        model.to_serving_layout("mixed", fuse=True)
    elif args.int4:
        # the fused decode plan takes <= 32 rows (predict.py and the
        # worker gate it the same way)
        fuse = args.batch == 1 and args.max_new_tokens <= 32
        model.to_serving_layout("int4", fuse=fuse)
        layout += " (fused)" if fuse else " (unfused)"
    rng = np.random.default_rng(args.seed)
    requests = []
    for i in range(args.batch):
        views, size = _views(args, cfg, rng, i)
        text = rng.integers(3, min(cfg.llada.vocab_size, 30000), size=24)
        ids = np.concatenate([text[:4], [-200], text[4:]])
        requests.append((ids, [views], [size]))
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        block_length=min(128, args.max_new_tokens),
        step_per_block=args.step_per_block)

    def run():
        if args.batch == 1:
            ids, views, sizes = requests[0]
            out = model.generate_fused(ids, views, sizes, gen,
                                       kv8=args.kv8)[None]
        else:
            out, _ = generate_batch(model, requests, gen, kv8=args.kv8)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    run()
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[predict] layout: {layout}{', kv8' if args.kv8 else ''}")
    for i, row in enumerate(out):
        print(f"[predict] output ids{'' if args.batch == 1 else f' {i}'}:",
              row.tolist())
    images = ", ".join(f"{r[2][0]} {r[1][0].shape[0]} views"
                       for r in requests)
    print(f"[predict] latency: {dt:.3f}s on {where} for {args.batch} "
          f"request(s) ({images}; len={args.max_new_tokens})")


if __name__ == "__main__":
    main()
