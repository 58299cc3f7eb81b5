"""The one traffic generator: it reads a mix's data file
(`benchmark/traffic/<mix>.json`) and makes its requests or batches from
the run's seed.  Every seed gets the same work: the same multiset of image
sizes and text lengths in every serving batch and in every training pool,
in another order, with other pixels, ids and masks.

The requests follow chip_smoke.py's `bench_request` (a seeded prompt with
the image marker after `marker_after` text tokens, seeded preprocessed
views for the image's anyres tiling, uniform in [-1, 1]) and its
`train_batch` (one image between a prompt and a supervised caption), with
their sizes and lengths taken from the mix file.
"""

from __future__ import annotations

import numpy as np

IMAGE_TOKEN = -200


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *keys])


def grid_views(size, vcfg: dict) -> int:
    """1 + the anyres tiles of an image of `size` (LLaVA's rule)."""
    from reference.lavida import tile_grid

    nw, nh = tile_grid(size, vcfg["grid_pinpoints"], vcfg["image_size"])
    return 1 + nw * nh


def image_tokens(size, vcfg: dict) -> int:
    """The merged block's rows of an image of `size`: the base view's
    pooled tokens, the unpadded tile grid and its newline rows."""
    import torch

    from reference.lavida import merge_image

    V = grid_views(size, vcfg)
    g = -(-(vcfg["image_size"] // vcfg["patch_size"]) // 2)
    return merge_image(torch.zeros(V, g * g, 1), size, vcfg,
                       torch.zeros(1)).shape[0]


def _views(rng, size, vcfg):
    S = vcfg["image_size"]
    v = rng.random((grid_views(size, vcfg), 3, S, S), dtype=np.float32)
    return v * np.float32(2.0) - np.float32(1.0)


def _spread(lo: int, hi: int, n: int) -> list[int]:
    return [int(round(x)) for x in np.linspace(lo, hi, n)]


def serve_batch(mix: dict, vcfg: dict, seed: int, index: int) -> list[dict]:
    """Batch `index` of a serving mix: `batch` requests, each {"ids"
    (text with the marker), "views" [V, 3, S, S], "size", "image_tokens",
    "prefix_len"}.  Request i takes size i of the mix's list (repeated to
    the batch) and the i-th of the prompt lengths evenly spread over the
    mix's range; the seed orders these pairs and draws the pixels and
    ids."""
    rng = rng_for(seed, 1, index)
    B = mix["batch"]
    sizes = [tuple(s) for s in mix["image_sizes"]]
    sizes = [sizes[i % len(sizes)] for i in range(B)]
    lens = _spread(*mix["prompt_tokens"], B)
    order = rng.permutation(B)          # the same pairs, in another order
    sizes, lens = [sizes[i] for i in order], [lens[i] for i in order]
    lo, hi = mix["text_ids"]
    out = []
    for size, n in zip(sizes, lens):
        text = rng.integers(lo, hi, size=n)
        m = mix["marker_after"]
        ids = np.concatenate([text[:m], [IMAGE_TOKEN], text[m:]])
        n_img = image_tokens(size, vcfg)
        out.append({"ids": ids, "views": _views(rng, size, vcfg),
                    "size": size, "image_tokens": n_img,
                    "prefix_len": n + n_img})
    return out


def train_batch(mix: dict, vcfg: dict, seed: int, index: int) -> dict:
    """Batch `index` of a training mix: {"samples": [{"ids", "labels",
    "views", "size", "length" (unpadded rows), "prefix_len"}], "T" (the
    rows padded to `seq_bucket`), "masked" [B, T] bool numpy}.  Each
    sample: `prompt_tokens` ids, the marker, `caption` ids that carry the
    labels.  The pool's `pool_batches` x `batch` samples take the mix's
    sizes (repeated to the pool) and caption lengths evenly spread over
    its range; the seed deals these pairs out to the batches, so every
    seed's pool holds the same work while each batch's sizes, view count
    and padded length are drawn.  The mask is the diffusion forward
    process of LLaDA's training (t ~ U(0, 1) a row, p = (1 - eps) t + eps,
    a position masked when its uniform draw is at most max(p, the row's
    least draw))."""
    B = mix["batch"]
    n = mix["pool_batches"] * B
    sizes = [tuple(s) for s in mix["image_sizes"]]
    sizes = [sizes[i % len(sizes)] for i in range(n)]
    caps = _spread(*mix["caption_tokens"], n)
    first = index % mix["pool_batches"] * B
    deal = rng_for(seed, 3).permutation(n)[first:first + B]
    sizes, caps = [sizes[i] for i in deal], [caps[i] for i in deal]
    rng = rng_for(seed, 2, index)
    lo, hi = mix["text_ids"]
    P = mix["prompt_tokens"]
    samples = []
    for size, c in zip(sizes, caps):
        text = rng.integers(lo, hi, size=P + c)
        ids = np.concatenate([text[:P], [IMAGE_TOKEN], text[P:]])
        labels = ids.copy()
        labels[:P + 1] = -100
        n_img = image_tokens(size, vcfg)
        samples.append({"ids": ids, "labels": labels,
                        "views": _views(rng, size, vcfg), "size": size,
                        "length": P + n_img + c, "prefix_len": P + n_img})
    T = -(-max(s["length"] for s in samples) // mix["seq_bucket"]) \
        * mix["seq_bucket"]
    t = rng.random(B, dtype=np.float32)
    eps = np.float32(mix["mask_eps"])
    p = (np.float32(1) - eps) * t + eps
    r = rng.random((B, T), dtype=np.float32)
    masked = r <= np.maximum(p, r.min(axis=1))[:, None]
    return {"samples": samples, "T": T, "masked": masked}
