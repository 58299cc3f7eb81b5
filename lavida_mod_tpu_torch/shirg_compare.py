"""SHIRG against the anyres baseline, side by side: the port of
scripts/shirg_compare.py (the reference's shirg/real_ocr_vqa_* runners).

    python -m lavida_mod_tpu_torch.shirg_compare --model-path CKPT \\
        --data samples.jsonl --shirg-method base --output results.json
    python -m lavida_mod_tpu_torch.shirg_compare --tiny --synthetic 4 \\
        [--device cpu]

For each image + question: the anyres baseline (`LaViDa.generate` on the
`process_images` views) and the SHIRG 2-view path (`process_shirg_2view`,
`shirg_encode`, `generate(image_features=...)`), each timed on the host
clock after a device sync, with the selection's own time and the token
count; exact match against `target` when a tokenizer gives text.  One
JSON line per sample, then the summary; `--output` writes both.

Without --model-path (or with --tiny) the toy geometry runs from a seeded
f32 init; with it, `LaViDa.load` of the checkpoint (bf16) and its
tokenizer.  The synthetic prompt ids without a tokenizer are seeded from
a CRC of the question (the script's `hash()` is salted per process).
`--data` is jsonl of {image, text, target?}, images relative to the file.
"""

from __future__ import annotations

import argparse
import json
import os
import string
import time
import zlib

import numpy as np

_PUNCT = str.maketrans("", "", string.punctuation)


def exact_match(prediction: str, target: str) -> float:
    """eval/metrics.py's exact_match: equal after lower-casing, dropping
    punctuation and collapsing whitespace."""
    def norm(s):
        return " ".join(s.lower().translate(_PUNCT).split())
    return float(norm(prediction) == norm(target))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--data", default=None,
                    help="jsonl: {image, text, target?}")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--shirg-method", default="base")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from .config import GenerationConfig, LaViDaConfig
    from .data import SigLIPImageProcessor, process_images
    from .models.lavida import LaViDa
    from .models.shirg import process_shirg_2view, shirg_encode
    from .predict import tiny_config

    device = torch.device(args.device)
    if args.tiny or not args.model_path:
        model = LaViDa.random_init(tiny_config(), 0, torch.float32, device)
        tokenizer = None
    else:
        from .data.tokenizer import load_hf_or_offline

        model = LaViDa.load(args.model_path, LaViDaConfig(), device=device)
        tokenizer = load_hf_or_offline(args.model_path)
    cfg = model.cfg
    proc = SigLIPImageProcessor(size=cfg.vision.siglip.image_size)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           block_length=min(128, args.max_new_tokens),
                           prefix_lm=True)

    samples = []
    if args.data:
        base = os.path.dirname(args.data)
        with open(args.data) as f:
            for line in f:
                d = json.loads(line)
                d["pil"] = Image.open(os.path.join(base, d["image"])
                                      ).convert("RGB")
                samples.append(d)
    else:
        rng = np.random.default_rng(0)
        for i in range(max(args.synthetic, 2)):
            samples.append({"text": f"what is item {i}?",
                            "pil": Image.fromarray(rng.integers(
                                0, 255, (300, 400, 3), dtype=np.uint8))})

    def ids_for(text):
        if tokenizer is not None:
            from .data.conversation import get_conv_template
            from .data.prompts import tokenizer_image_token

            conv = get_conv_template("llada")
            conv.tokenizer = tokenizer
            conv.append_message(conv.roles[0], "<image>\n" + text)
            return tokenizer_image_token(conv.get_prompt(), tokenizer)
        ids = np.random.default_rng(zlib.crc32(text.encode())).integers(
            3, 400, size=12)
        return np.concatenate([ids[:4], [-200], ids[4:]]).astype(np.int64)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    rows = []
    for s in samples:
        ids = ids_for(s["text"])
        views = process_images([s["pil"]], proc, cfg.vision)[0]
        t0 = clock()
        out_b = model.generate(ids, [views], [s["pil"].size], gen)
        t_base = clock() - t0
        t0 = clock()
        sv = process_shirg_2view(s["pil"], proc)
        t_sel0 = clock()
        with torch.no_grad():
            block = shirg_encode(model, sv, method=args.shirg_method)
        sel_ms = (clock() - t_sel0) * 1e3
        out_s = model.generate(ids, gen=gen, image_features=[block])
        t_shirg = clock() - t0
        row = {"question": s["text"],
               "baseline_latency_s": round(t_base, 4),
               "shirg_latency_s": round(t_shirg, 4),
               "shirg_selection_ms": round(sel_ms, 2),
               "shirg_tokens": int(block.shape[0])}
        if tokenizer is not None:
            row["baseline_answer"] = model.decode_output(out_b, tokenizer)
            row["shirg_answer"] = model.decode_output(out_s, tokenizer)
            if "target" in s:
                row["baseline_acc"] = exact_match(row["baseline_answer"],
                                                  s["target"])
                row["shirg_acc"] = exact_match(row["shirg_answer"],
                                               s["target"])
        rows.append(row)
        print(json.dumps(row))

    def mean(k, nd):
        return round(float(np.mean([r[k] for r in rows])), nd)

    summary = {"method": args.shirg_method, "n": len(rows),
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "avg_baseline_latency_s": mean("baseline_latency_s", 4),
               "avg_shirg_latency_s": mean("shirg_latency_s", 4),
               "avg_selection_ms": mean("shirg_selection_ms", 2),
               "results": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "results"}))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
