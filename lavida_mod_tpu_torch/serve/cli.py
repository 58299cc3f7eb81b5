"""Terminal chat, the port of lavida_mod_tpu/serve/cli.py (reference
llava/serve/cli.py analogue): an interactive multi-turn conversation about
one image with a local model, no server.

Usage:
  python -m lavida_mod_tpu_torch.serve.cli [--model-path DIR] [--image PATH]
      [--quant none|int8|int4|mixed] [--max-new-tokens 64]
      [--conv-template llada] [--device cuda] [--tiny]

With --model-path the checkpoint is loaded onto --device (the card unless
`--device cpu`) and put in the --quant serving layout (weight-only int8 by
default; int4 and mixed take the fused decode layout for 32 new tokens or
fewer), and its tokenizer answers in text.  --tiny (or no --model-path)
chats with a random 2-layer toy model in ids.  --tp N with --model-path
serves the bf16 checkpoint tensor-parallel over N ranks (cli.py:59-65,
`LaViDa.shard`; --quant must be none, as the JAX chat requires): run it
under torchrun with N processes; rank 0 reads each line and broadcasts
it, every rank generates, rank 0 prints.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--conv-template", default="llada")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N ranks "
                         "(torchrun; with --model-path and --quant none)")
    ap.add_argument("--quant", choices=["none", "int8", "int4", "mixed"],
                    default="int8",
                    help="LM serving layout: weight-only int8 (default), "
                         "int4 = W4A8, mixed = int8 prefill + int4 decode, "
                         "none = the checkpoint's bf16")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card unless 'cpu'")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..config import GenerationConfig
    from ..data import SigLIPImageProcessor, process_images
    from ..data.conversation import get_conv_template
    from ..data.prompts import tokenizer_image_token
    from ..data.tokenizer import load_hf_or_offline
    from ..models.lavida import LaViDa
    from ..parallel.lockstep import broadcast, rank
    from ..predict import tiny_config

    device = torch.device(args.device)
    if args.tiny or not args.model_path:
        model = LaViDa.random_init(tiny_config(), 0, torch.float32, device)
        tokenizer = None
        print("[cli] tiny random model (no checkpoint)")
    elif args.tp > 1:
        if args.quant != "none":
            raise SystemExit("--tp is bf16 serving; use --quant none")
        from ..parallel import maybe_init_distributed

        maybe_init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        model = LaViDa.load(args.model_path, None, torch.bfloat16,
                            device=device).shard(tp=args.tp)
        tokenizer = load_hf_or_offline(args.model_path)
    else:
        model = LaViDa.load(args.model_path, None, torch.bfloat16,
                            device=device)
        model.to_serving_layout(
            quant=args.quant,
            # the fused decode layout only for short generations
            fuse=(args.quant in ("int4", "mixed")
                  and args.max_new_tokens <= 32))
        tokenizer = load_hf_or_offline(args.model_path)
    cfg = model.cfg

    images, sizes = [], []
    if args.image:
        from PIL import Image

        img = Image.open(args.image)
        proc = SigLIPImageProcessor(size=cfg.vision.siglip.image_size)
        images = [process_images([img], proc, cfg.vision)[0]]
        sizes = [img.size]

    conv = get_conv_template(args.conv_template)
    if tokenizer is not None:
        conv.tokenizer = tokenizer
    first = True
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        block_length=min(128, args.max_new_tokens),
    )
    lead = rank() == 0
    while True:
        user = None
        if lead:
            try:
                user = input("USER: ").strip()
            except EOFError:
                user = None
        user = broadcast(user)      # rank 0's line on every --tp rank
        if not user or user in ("exit", "quit"):
            break
        msg = ("<image>\n" + user) if (first and images) else user
        first = False
        conv.append_message(conv.roles[0], msg)
        prompt = conv.get_prompt()
        if tokenizer is not None:
            ids = tokenizer_image_token(prompt, tokenizer)
        else:
            rng = np.random.default_rng(len(prompt))
            ids = np.concatenate([
                rng.integers(3, 400, size=6),
                [-200] if images else [],
                rng.integers(3, 400, size=6),
            ]).astype(np.int64)
        out = model.generate(ids, images, sizes, gen)
        reply = (model.decode_output(out, tokenizer) if tokenizer is not None
                 else " ".join(map(str, out[:16])))
        conv.append_message(conv.roles[1], reply)
        if lead:
            print("ASSISTANT:", reply)


if __name__ == "__main__":
    main()
