"""Single-image prediction CLI of the port: the counterpart of the repo's
predict.py.

Usage:
  python -m lavida_mod_tpu_torch.predict [--model-path DIR] [--tiny]
      [--prompt TEXT] [--conv-template llada] [--dtype bfloat16]
      [--mixed | --int4] [--kv8 | --kv4] [--batch N] [--image PATH]
      [--max-new-tokens 32] [--steps N] [--step-per-block 16]
      [--step-ratio R] [--block-length N] [--schedule shift]
      [--schedule-shift 3.0] [--remasking low_confidence]
      [--aspect anyres|square|pad] [--no-prefix-cache]
      [--shirg [--shirg-method base]] [--seed 0] [--device cuda]

With --model-path the model is `LaViDa.load` of that checkpoint directory
(its geometry from its config.json, or the toy geometry with --tiny) in
--dtype, straight onto the device, and its tokenizer is read from the
same directory (`load_hf_or_offline`): the prompt goes through the
conversation template (--conv-template) and `tokenizer_image_token`, and
the answer is printed as text, cut at EOS or the template's stop ids.
Without it, the full LaViDaConfig() geometry (LLaDA-8B + SigLIP so400m;
the 2-layer toy with --tiny) is initialised on the device from --seed,
the prompt is synthetic ids and the output is ids.  --mixed quantizes the
LM there into the mixed serving layout (int8 prefill tree + int4 decode
tree, bench.py's default; the repo's predict.py --mixed); --int4 into the
single grouped-int4 tree.  The decode tree takes the fused layout for
one request of 32 or fewer tokens (predict.py:177's gate), else it stays
unfused (the serve worker's --int4 --decode-batch N).  --kv8 decodes over
the int8 KV cache, --kv4 over the int4 one (exclusive, as bench.py makes
them).  --batch N serves N requests of different image sizes
in one batch (eval.adapter.generate_batch) instead of one request through
generate_fused.  --image goes through the anyres preprocessing of
lavida_mod_tpu_torch.data (needs PIL) for every request; without it the
views are seeded numpy pixels (a 640x640 image, 100x60 with --tiny, and
other sizes for the rest of a batch).  --no-prefix-cache generates
without the prefix cache (each denoise step runs the whole forward over
the prompt and the answer; one request through LaViDa.generate); with
--mixed it exits, as the JAX package's generate refuses the mixed split
without the cache.  --shirg (with --shirg-method, predict.py:186-205)
replaces the anyres encode by SHIRG's 2-view selection
(models/shirg.py): the image (--image, else a seeded one of the request's
size) goes through `process_shirg_2view` and `shirg_encode` to a
980-token block, spliced by `LaViDa.generate(image_features=...)`, one
request (no --batch).  --tp N serves the bf16 model tensor-parallel
over N ranks (`LaViDa.shard(tp=N)`): run it under torchrun with N
processes, one card each (gloo on the CPU); rank 0 owns the requests and
broadcasts them, every rank generates, rank 0 prints.  As the repo's
predict.py, --tp refuses the quantized layouts and the quantized KV
caches.  The generation flags (--steps, --step-per-block, --step-ratio,
--block-length, --schedule, --schedule-shift, --remasking) make the
GenerationConfig as predict.py:225-239 makes it (`generation_config`),
and --aspect sets the vision config's image_aspect_ratio, over the
checkpoint's (predict.py:115, :123, :150-152): "square" or "pad" encode
one view per image.  Prints the answers and the latency, timed after a
warm-up run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def tiny_config(aspect: str = "anyres"):
    """The 2-layer toy geometry of the tests (tests/test_bucketing.py)."""
    from .config import (LaViDaConfig, VisionConfig, tiny_llada_config,
                         tiny_siglip_config)

    return LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                            grid_pinpoints=((56, 112), (112, 56),
                                            (112, 112)),
                            image_aspect_ratio=aspect))


def with_aspect(cfg, aspect):
    """`cfg` with the vision config's image_aspect_ratio set to `aspect`
    (predict.py:150-152), or as it is when aspect is None."""
    if not aspect:
        return cfg
    return cfg.replace(vision=cfg.vision.replace(image_aspect_ratio=aspect))


def generation_config(args):
    """The GenerationConfig of the flags, as predict.py:225-239 builds it:
    block_length defaults to min(128, max_new_tokens)."""
    from .config import GenerationConfig

    return GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        block_length=(args.block_length if args.block_length
                      else min(128, args.max_new_tokens)),
        steps=args.steps,
        step_per_block=args.step_per_block,
        step_ratio=args.step_ratio,
        schedule=args.schedule,
        schedule_shift=args.schedule_shift,
        remasking=args.remasking,
        prefix_lm=not args.no_prefix_cache,
    )


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
    n = 1
    if cfg.vision.image_aspect_ratio.startswith("anyres"):
        nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, S)
        n += nw * nh
    views = rng.uniform(-1, 1, (n, 3, S, S)).astype(np.float32)
    return views, size




def _shirg_image(args, rng, i=0):
    """The PIL image of request i for --shirg: --image, else seeded
    pixels of the request's size."""
    from PIL import Image

    if args.image:
        return Image.open(args.image).convert("RGB")
    sizes = TINY_SIZES if args.tiny else SIZES
    w, h = sizes[i % len(sizes)]
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", default=None,
                    help="a reference-layout checkpoint directory")
    ap.add_argument("--prompt", default="Describe the image in detail.")
    ap.add_argument("--conv-template", default="llada")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer toy geometry instead of LaViDaConfig()")
    layout = ap.add_mutually_exclusive_group()
    layout.add_argument("--mixed", action="store_true",
                        help="serve the mixed int8-prefill / int4-decode "
                        "layout")
    layout.add_argument("--int4", action="store_true",
                        help="serve the grouped-int4 layout")
    kv = ap.add_mutually_exclusive_group()
    kv.add_argument("--kv8", action="store_true",
                    help="decode over the int8 KV cache")
    kv.add_argument("--kv4", action="store_true",
                    help="decode over the int4 KV cache")
    ap.add_argument("--batch", type=int, default=1,
                    help="requests served together (generate_batch)")
    ap.add_argument("--image", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--step-per-block", type=int, default=None)
    ap.add_argument("--step-ratio", type=float, default=None)
    ap.add_argument("--block-length", type=int, default=None)
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--schedule-shift", type=float, default=3.0)
    ap.add_argument("--remasking", default="low_confidence")
    ap.add_argument("--aspect", default=None,
                    help="anyres|square|pad; default: the checkpoint's "
                         "image_aspect_ratio (anyres without one)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="generate without the prefix KV cache")
    ap.add_argument("--shirg", action="store_true",
                    help="SHIRG-Fovea 2-view token selection instead of "
                    "anyres")
    ap.add_argument("--shirg-method", default="base")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N ranks (run "
                         "under torchrun with N processes)")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.tp > 1:
        # predict.py:126-140's refusals, in its words
        if args.int4 or args.mixed:
            raise SystemExit(
                "--tp is bf16 serving (quantized layouts have custom leaf "
                "structures the sharding rules don't cover); drop "
                "--int4/--mixed — tp>=2 fits the bf16 8B without them")
        if args.kv8 or args.kv4:
            raise SystemExit("--tp is bf16 serving; drop --kv8/--kv4 "
                             "(tp>=2 has the HBM headroom kv8 buys)")
    if args.shirg and args.batch != 1:
        ap.error("--shirg serves one request (predict.py's generate with "
                 "image_features); drop --batch")
    if args.no_prefix_cache and args.mixed:
        ap.error("--no-prefix-cache with --mixed: mixed decode_params needs "
                 "the prefix-cache mode (prefix_lm=True) — the no-cache path "
                 "has no prefill/decode split")

    import torch

    from .config import LaViDaConfig
    from .data.conversation import get_conv_template
    from .data.prompts import tokenizer_image_token
    from .data.tokenizer import load_hf_or_offline
    from .eval.adapter import generate_batch
    from .models.lavida import LaViDa

    from .parallel import maybe_init_distributed
    from .parallel.lockstep import broadcast, rank

    device = torch.device(args.device)
    if args.tp > 1:
        maybe_init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    dtype = getattr(torch, args.dtype)
    tokenizer = None
    aspect = args.aspect or "anyres"
    if args.model_path:
        model = LaViDa.load(args.model_path,
                            tiny_config(aspect) if args.tiny else None, dtype,
                            device=device)
        # an explicit --aspect beats the checkpoint's (predict.py:150-152)
        model.cfg = with_aspect(model.cfg, args.aspect)
        tokenizer = load_hf_or_offline(args.model_path)
    else:
        cfg = LaViDaConfig()
        if args.tiny:
            cfg = (tiny_mixed_config() if args.mixed or args.int4
                   else tiny_config())
        model = LaViDa.random_init(with_aspect(cfg, aspect), args.seed,
                                   dtype, device)
    if args.tp > 1:
        model.shard(tp=args.tp)
    cfg = model.cfg
    layout = ("mixed" if args.mixed else "int4" if args.int4
              else args.dtype) + (f", tp {args.tp}" if args.tp > 1 else "")
    if args.mixed or args.int4:
        # the fused decode plan takes <= 32 rows: predict.py:177 fuses for
        # 32 tokens or fewer, the worker's --int4 for one request only
        fuse = args.max_new_tokens <= 32 and (args.mixed or args.batch == 1)
        model.to_serving_layout("mixed" if args.mixed else "int4", fuse=fuse)
        layout += " (fused)" if fuse else " (unfused)"
    conv = get_conv_template(args.conv_template)
    if tokenizer is not None:
        if getattr(tokenizer, "chat_template", None):
            conv.tokenizer = tokenizer
        conv.append_message(conv.roles[0], "<image>\n" + args.prompt)
        prompt_ids = tokenizer_image_token(conv.get_prompt(), tokenizer)
    rng = np.random.default_rng(args.seed)
    requests = []
    for i in range(args.batch):
        if args.shirg:
            from .data import SigLIPImageProcessor
            from .models.shirg import process_shirg_2view

            img = _shirg_image(args, rng, i)
            views, size = process_shirg_2view(img, SigLIPImageProcessor(
                size=cfg.vision.siglip.image_size)), img.size
        else:
            views, size = _views(args, cfg, rng, i)
        if tokenizer is not None:
            ids = prompt_ids
        else:
            text = rng.integers(3, min(cfg.llada.vocab_size, 30000),
                                size=24)
            ids = np.concatenate([text[:4], [-200], text[4:]])
        requests.append((ids, [views], [size]))
    requests = broadcast(requests)      # rank 0's requests on every rank
    gen = generation_config(args)

    kv8 = 4 if args.kv4 else args.kv8

    shirg_tokens = []

    def run():
        if args.shirg:
            from .models.shirg import shirg_encode

            ids, views, sizes = requests[0]
            block = shirg_encode(model, views[0], method=args.shirg_method)
            shirg_tokens[:] = [block.shape[0]]
            out = model.generate(ids, gen=gen, kv8=kv8,
                                 image_features=[block])[None]
        elif args.batch == 1:
            ids, views, sizes = requests[0]
            run1 = model.generate_fused if gen.prefix_lm else model.generate
            out = run1(ids, views, sizes, gen, kv8=kv8)[None]
        else:
            out, _ = generate_batch(model, requests, gen, kv8=kv8)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    run()
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    if rank() != 0:
        return
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    cache = (", no prefix cache" if args.no_prefix_cache else
             ", kv8" if args.kv8 else ", kv4" if args.kv4 else "")
    print(f"[predict] layout: {layout}{cache}")
    if args.shirg:
        print(f"[predict] shirg: {shirg_tokens[0]} tokens from 2 views of "
              f"448^2 (method {args.shirg_method}, image {requests[0][2][0]})")
    for i, row in enumerate(out):
        tag = "" if args.batch == 1 else f" {i}"
        if tokenizer is not None:
            print(f"[predict] answer{tag}:", model.decode_output(
                row, tokenizer, conv.stop_token_ids))
        else:
            print(f"[predict] output ids{tag}:", row.tolist())
    images = ", ".join(f"{r[2][0]} {r[1][0].shape[0]} views"
                       for r in requests)
    print(f"[predict] latency: {dt:.3f}s on {where} for {args.batch} "
          f"request(s) ({images}; len={args.max_new_tokens})")


if __name__ == "__main__":
    main()
