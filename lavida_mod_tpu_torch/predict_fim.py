"""FIM (fill-in-the-middle) inference CLI of the port: the counterpart of
the repo's predict_fim.py.  A draft answer skeleton with `<|mdm_mask|>`
holes and `<|reserved_token_1|>` infill markers is written into the
generation buffer (generate.py:189-191); only the holes are denoised, the
rest of the draft is kept verbatim (asserted).

Usage:
  python -m lavida_mod_tpu_torch.predict_fim --model-path CKPT \\
      [--image img.png] [--prompt "Write a poem about the image."] \\
      [--draft TEXT] [--max-new-tokens 256] [--step-ratio 1.0] \\
      [--schedule shift --schedule-shift 0.3333] [--device cuda]

With --model-path the model is `LaViDa.load` of the checkpoint (its
geometry from config.json) on --device, laid out as weight-only int8
(`to_serving_layout("int8")`), with the checkpoint's tokenizer, the llada
template and the draft text.  Without it, or with --tiny, the 2-layer toy
model runs in f32 from --seed with synthetic ids and a seeded draft whose
holes are ids == mask.  The answer buffer is max(--max-new-tokens, the
draft's length) rounded up to a multiple of 32, in one block.
"""

from __future__ import annotations

import argparse

import numpy as np

FIM_TOKEN = "<|reserved_token_1|>"
MASK_TOKEN = "<|mdm_mask|>"

DEFAULT_DRAFT = (
    "\nSure, here is a poem about the image:\n"
    + ("A" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + ("Be" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + ("Ca" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + ("De" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + "<|eot_id|>"
)


def main(argv=None) -> dict:
    """Run one FIM request; returns {"ids": [G] ids, "draft": [Td] ids,
    "text": the decoded answer or None, "walls": s per stage (model,
    tokenizer, generate; each ending in a device synchronize)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--prompt", default="Write a poem about the image.")
    ap.add_argument("--draft", default=DEFAULT_DRAFT)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--step-ratio", type=float, default=1.0)
    ap.add_argument("--schedule", default="shift")
    ap.add_argument("--schedule-shift", type=float, default=1 / 3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import time

    import torch

    from .config import GenerationConfig
    from .data import SigLIPImageProcessor, process_images
    from .data.conversation import get_conv_template
    from .data.prompts import tokenizer_image_token
    from .models.lavida import LaViDa
    from .predict import tiny_config

    device = torch.device(args.device)
    walls, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls[name], t0 = time.perf_counter() - t0, time.perf_counter()

    tiny = args.tiny or not args.model_path
    if tiny:
        model = LaViDa.random_init(tiny_config(), args.seed, torch.float32,
                                   device)
        print("[predict_fim] random-init tiny model")
    else:
        model = LaViDa.load(args.model_path, device=device)
        model.to_serving_layout("int8")
    stage("model")
    tokenizer = None
    if not tiny:
        from .data.tokenizer import load_hf_or_offline

        tokenizer = load_hf_or_offline(args.model_path)
        stage("tokenizer")
    cfg = model.cfg

    images, sizes = [], []
    if args.image:
        from PIL import Image

        img = Image.open(args.image)
        proc = SigLIPImageProcessor(size=cfg.vision.siglip.image_size)
        images = [process_images([img], proc, cfg.vision)[0]]
        sizes = [img.size]
        user_msg = "<image>\n" + args.prompt
    else:
        user_msg = args.prompt

    conv = get_conv_template("llada")
    if tokenizer is not None:
        conv.tokenizer = tokenizer
    conv.append_message(conv.roles[0], user_msg)
    prompt = conv.get_prompt()

    mask_id = cfg.llada.mask_token_id
    if tokenizer is not None:
        input_ids = tokenizer_image_token(prompt, tokenizer)
        draft_tokens = np.asarray(tokenizer(args.draft).input_ids)
    else:
        rng = np.random.default_rng(args.seed)
        input_ids = np.concatenate(
            [rng.integers(3, 400, size=6),
             [-200] if args.image else [],
             rng.integers(3, 400, size=8)]).astype(np.int64)
        draft_tokens = rng.integers(3, 400, size=24)
        draft_tokens[rng.random(24) < 0.5] = mask_id

    G = max(args.max_new_tokens, len(draft_tokens))
    G = ((G + 31) // 32) * 32  # block alignment
    gen = GenerationConfig(
        max_new_tokens=G, block_length=G,
        step_ratio=args.step_ratio, schedule=args.schedule,
        schedule_shift=args.schedule_shift, prefix_lm=True)
    out = model.generate(input_ids, images, sizes, gen,
                         draft_tokens=draft_tokens)
    stage("generate")
    # drafted (non-hole) positions survive
    keep = draft_tokens != mask_id
    if not (out[: len(draft_tokens)][keep] == draft_tokens[keep]).all():
        raise AssertionError("a drafted position was overwritten")
    text = None
    if tokenizer is not None:
        text = tokenizer.decode(out, skip_special_tokens=False)
        print(text.replace("<|endoftext|>", ""))
    else:
        print("[predict_fim] output ids:", out.tolist())
        print("[predict_fim] holes filled:",
              int((np.asarray(out) != mask_id).sum()), "/", len(out))
    print("[predict_fim] walls: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()) + f" on {device}")
    return {"ids": out, "draft": draft_tokens, "text": text,
            "walls": walls}


if __name__ == "__main__":
    main()
