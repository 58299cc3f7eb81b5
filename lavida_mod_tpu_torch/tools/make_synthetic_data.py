"""A synthetic LLaVA-layout finetune dataset (PNG images + json), the
port's copy of scripts/make_synthetic_data.py: for the same arguments the
same json and the same pixels (numpy's default_rng(0), PIL's PNG writer).

It drives the training CLI end to end with no downloaded data.  The schema
is the reference's LLaVA json ("image" + "conversations", <image> in the
first human turn).

Usage:
  python -m lavida_mod_tpu_torch.tools.make_synthetic_data OUT_DIR [--n 64] [--size 384]
  -> OUT_DIR/data.json + OUT_DIR/images/*.png
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

CAPTIONS = [
    "A colorful gradient test pattern with a bright diagonal stripe.",
    "A dark noisy field with a small light square in one corner.",
    "Horizontal bands of alternating warm and cool colors.",
    "A radial burst of color centered slightly off the middle.",
]


def make(out_dir: str, n: int = 64, size: int = 384) -> str:
    """Write n records and their size x size images; returns the json's
    path."""
    from PIL import Image

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(n):
        name = f"img_{i:04d}.png"
        arr = (rng.random((size, size, 3)) * 255).astype("uint8")
        # some structure, so that captions are not pure noise
        arr[:, : size // 4, i % 3] = 255
        Image.fromarray(arr).save(os.path.join(img_dir, name))
        records.append({
            "id": f"syn-{i}",
            "image": name,
            "conversations": [
                {"from": "human", "value": "<image>\nDescribe this image."},
                {"from": "gpt", "value": CAPTIONS[i % len(CAPTIONS)]},
            ],
        })
    path = os.path.join(out_dir, "data.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--size", type=int, default=384)
    args = ap.parse_args(argv)
    path = make(args.out_dir, args.n, args.size)
    print(f"wrote {args.n} records -> {path} (images in "
          f"{os.path.join(args.out_dir, 'images')})")


if __name__ == "__main__":
    main()
