"""Training dataset, mixtures and collator: the port's copy of
lavida_mod_tpu/data/dataset.py (host code: json, numpy, PIL), held equal to
it by tests/test_torch_data.py.

Parity with reference llava/train/train.py:
  - SupervisedDataset ~ LazySupervisedDataset (:1260-1558): json / jsonl /
    yaml mixture loading with first/end/random[:N|%] sampling strategies,
    per-yaml image_root, per-sample retry (3x same, 3x neighbor), length /
    modality_length properties for length-grouped sampling;
  - collate_batch ~ DataCollatorForSupervisedDataset (:1560-1612): pad to
    max-in-batch PLUS a random extra pad in [-128, 128) (the
    diffusion-specific length-robustness trick, :1589-1591), images kept as
    per-sample view stacks;
  - the eos-as-target padding trick (llava_llada.py:129-133) applied here:
    labels at eos positions revert to eos so the model learns to emit eos
    after the answer, with no sequence attention mask (paper Sec B.1).

One difference: the yaml "random" strategy shuffles with the
`random.Random` given to `load_mixture` (SupervisedDataset passes one
seeded from its seed), where the JAX package shuffles with the global
`random` module's unseeded state; given the same state both draw the same
permutation.  `load_mixture` without one uses the global module, as JAX's
does.  PyYAML is imported only for a yaml mixture.
"""

from __future__ import annotations

import json
import math
import os
import random
import re
from typing import Optional, Sequence

import numpy as np

from ..config import VisionConfig
from ..constants import IGNORE_INDEX
from .image_processor import SigLIPImageProcessor, process_images
from .preprocess import preprocess_diffusion


def load_mixture(data_path: str,
                 shuffle_rng: Optional[random.Random] = None) -> list[dict]:
    """json / {a,b}.json / jsonl / yaml mixture -> list of samples; the
    yaml "random" strategy shuffles with `shuffle_rng` (default: the
    global `random` module)."""
    shuffle = (shuffle_rng or random).shuffle
    records: list[dict] = []

    def load_file(p: str) -> list[dict]:
        if p.endswith(".jsonl"):
            with open(p) as f:
                return [json.loads(l) for l in f if l.strip()]
        with open(p) as f:
            return json.load(f)

    if "{" in data_path and "}" in data_path:
        base, names = re.match(r"^(.*)\{(.*)\}\.json$", data_path).groups()
        for n in names.split(","):
            records.extend(load_file(f"{base}{n}.json"))
        return records

    if data_path.endswith(".yaml"):
        import yaml

        with open(data_path) as f:
            spec = yaml.safe_load(f)
        for ds in spec.get("datasets", []):
            cur = load_file(ds["json_path"])
            strategy = ds.get("sampling_strategy", "all")
            n = None
            if ":" in strategy:
                strategy, num = strategy.split(":")
                n = (
                    math.ceil(int(num.rstrip("%")) * len(cur) / 100)
                    if "%" in num else int(num)
                )
            if strategy == "first" and n is not None:
                cur = cur[:n]
            elif strategy == "end" and n is not None:
                cur = cur[-n:]
            elif strategy == "random" and n is not None:
                shuffle(cur)
                cur = cur[:n]
            root = ds.get("image_root")
            if root:
                for s in cur:
                    if "image" in s and not os.path.isabs(s["image"]):
                        s["image"] = os.path.join(root, s["image"])
            records.extend(cur)
        return records

    return load_file(data_path)


class SupervisedDataset:
    def __init__(
        self,
        data_path: str,
        tokenizer,
        vision_cfg: VisionConfig,
        image_folder: str = "",
        style: str = "llada",
        is_infill_model: bool = False,
        seed: int = 0,
    ):
        self.records = load_mixture(data_path, random.Random(seed))
        self.tokenizer = tokenizer
        self.vision_cfg = vision_cfg
        self.image_folder = image_folder
        self.style = style
        self.is_infill_model = is_infill_model
        self.processor = SigLIPImageProcessor(size=vision_cfg.siglip.image_size)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def lengths(self) -> list[int]:
        out = []
        for s in self.records:
            img = 128 if "image" in s else 0
            out.append(img + sum(
                len(c.get("value", c.get("content", "")).split())
                for c in s["conversations"]
            ))
        return out

    @property
    def modality_lengths(self) -> list[int]:
        out = []
        for s in self.records:
            n = sum(
                len(c.get("value", c.get("content", "")).split())
                for c in s["conversations"]
            )
            out.append(n if ("image" in s or "video" in s) else -n)
        return out

    def _load_images(self, rec: dict):
        """Decode + anyres-process a record's images.  rng-free and
        therefore safe to run on worker threads (PIL decode and the
        numpy resize/normalize release the GIL)."""
        from PIL import Image

        files = (rec["image"] if isinstance(rec["image"], list)
                 else [rec["image"]])
        imgs = []
        for f in files:
            p = f if os.path.isabs(f) else os.path.join(
                self.image_folder, f
            )
            imgs.append(Image.open(p).convert("RGB"))
        views = process_images(imgs, self.processor, self.vision_cfg)
        return views, [im.size for im in imgs]

    def _get_item(self, i: int, preloaded=None) -> dict:
        rec = self.records[i]
        has_image = "image" in rec
        item = preprocess_diffusion(
            rec["conversations"], self.tokenizer, self.style,
            has_image=has_image, rng=self.rng,
            is_infill_model=self.is_infill_model,
        )
        if has_image:
            views, sizes = (preloaded if preloaded is not None
                            else self._load_images(rec))
            item["images"] = views
            item["image_sizes"] = sizes
        else:
            item["images"] = []
            item["image_sizes"] = []
        return item

    def __getitem__(self, i: int) -> dict:
        # retry policy: 3x same sample, 3x neighbor (train.py:1418-1448)
        for _ in range(3):
            try:
                return self._get_item(i)
            except Exception as e:  # noqa: BLE001
                err = e
        for _ in range(3):
            try:
                return self._get_item(min(i + 1, len(self) - 1))
            except Exception:  # noqa: BLE001
                pass
        raise err

    def get_batch(self, indices, pool=None) -> list[dict]:
        """Fetch a batch with the heavy rng-free image decode fanned out
        over `pool` (concurrent.futures Executor) while the rng-dependent
        text preprocess runs sequentially in index order -- so the rng
        stream (and thus every token/label) is bit-identical to
        `[ds[i] for i in indices]`.  This is the torch
        `dataloader_num_workers=4` analogue (reference
        llada-hd-llada-s2.sh) for the path the 913m chip drive measured
        as the step bottleneck (one producer thread: 3436 tok/s vs the
        6936 tok/s device ceiling).  A failed parallel decode falls back
        to the sequential retry-policy path for that item (rare; the
        fallback re-rolls that item's rng draws, same as a retry)."""
        if pool is None:
            return [self[int(i)] for i in indices]
        futs = {}
        for j, i in enumerate(indices):
            rec = self.records[int(i)]
            if "image" in rec:
                futs[j] = pool.submit(self._load_images, rec)
        out = []
        for j, i in enumerate(indices):
            f = futs.get(j)
            try:
                pre = f.result() if f is not None else None
                out.append(self._get_item(int(i), preloaded=pre))
            except Exception:  # noqa: BLE001
                out.append(self[int(i)])
        return out


def length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    mega_factor: int = 50,
) -> list[int]:
    """Length-grouped shuffling (reference llava_trainer.py:54-241
    LengthGroupedSampler): shuffle, take megabatches of
    mega_factor*batch_size, sort each by length descending -- random order
    globally, similar lengths within a batch (less padding waste).
    Negative lengths (text-only samples, modality_lengths convention) are
    grouped among themselves first, like the modality-grouped variant."""
    rng = rng or np.random.default_rng()
    lengths = np.asarray(lengths)
    order = rng.permutation(len(lengths))
    mm = [i for i in order if lengths[i] >= 0]
    txt = [i for i in order if lengths[i] < 0]
    out: list[int] = []
    for group in (mm, txt):
        mega = mega_factor * batch_size
        for lo in range(0, len(group), mega):
            chunk = group[lo : lo + mega]
            chunk = sorted(chunk, key=lambda i: -abs(int(lengths[i])))
            out.extend(chunk)
    return out


def collate_batch(
    instances: Sequence[dict],
    pad_token_id: int,
    eos_token_id: Optional[int] = None,
    model_max_length: Optional[int] = None,
    extra_pad: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """Pad to max-in-batch (+ random extra pad), apply the eos-target trick.

    Returns {"input_ids" [B,T], "labels" [B,T], "attention_mask" [B,T],
    "images": list[list[views]], "image_sizes": list[list[(w,h)]]}.
    """
    rng = rng or np.random.default_rng()
    ids = [np.asarray(x["input_ids"]) for x in instances]
    labs = [np.asarray(x["labels"]) for x in instances]
    if model_max_length:
        ids = [a[:model_max_length] for a in ids]
        labs = [a[:model_max_length] for a in labs]
    if extra_pad is None:
        extra_pad = int(rng.integers(-128, 128))
    T = max(a.shape[0] for a in ids) + max(extra_pad, 0)
    B = len(ids)
    input_ids = np.full((B, T), pad_token_id, np.int64)
    labels = np.full((B, T), IGNORE_INDEX, np.int64)
    attn = np.zeros((B, T), bool)
    for b, (a, l) in enumerate(zip(ids, labs)):
        input_ids[b, : len(a)] = a
        labels[b, : len(l)] = l
        attn[b, : len(a)] = True
    if eos_token_id is not None:
        # eos positions (incl. padding when pad==eos) become eos targets and
        # are attended (llava_llada.py:129-133)
        eos_pos = input_ids == eos_token_id
        labels[eos_pos] = eos_token_id
        attn[eos_pos] = True
    return {
        "input_ids": input_ids,
        "labels": labels,
        "attention_mask": attn,
        "images": [x["images"] for x in instances],
        "image_sizes": [x["image_sizes"] for x in instances],
    }
