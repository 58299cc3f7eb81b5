"""The traffic generator repeats under one seed, differs under another,
and gives every seed the same work (sizes and lengths, reordered): the
same in each serving batch, and in each training pool, whose batches draw
their sizes and lengths from it."""

import json
from pathlib import Path

import numpy as np
import pytest

from harness import traffic

BENCH = Path(__file__).resolve().parents[1]
CONF = json.loads((BENCH / "configs" / "lavida-llada-8b.json").read_text())
VCFG = dict(CONF["vision"], grid_pinpoints=[
    tuple(p) for p in CONF["composition"]["image_grid_pinpoints"]])
SEED = 2 ** 31 + 12345


def small(name):
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    mix["batch"] = 8 if mix["kind"] == "serve_batch" else 4
    return mix


def make(mix, seed, i):
    f = traffic.serve_batch if mix["kind"] == "serve_batch" else \
        traffic.train_batch
    return f(mix, VCFG, seed, i)


def flat(b):
    rows = b if isinstance(b, list) else b["samples"]
    return [(r["ids"].tolist(), r["views"][:, :, :2, :2].tolist(), r["size"])
            for r in rows]


def work(b):
    rows = b if isinstance(b, list) else b["samples"]
    return sorted((r["size"], len(r["ids"]), r["views"].shape[0])
                  for r in rows)


@pytest.mark.parametrize("name", ["serve-batch32-hd", "train-stage1-b4"])
def test_repeat_differ_same_work(name):
    mix = small(name)
    a, b, c = make(mix, SEED, 0), make(mix, SEED, 0), make(mix, SEED + 1, 0)
    assert flat(a) == flat(b)
    assert flat(a) != flat(c)
    assert flat(make(mix, SEED, 1)) != flat(a)
    if mix["kind"] == "serve_batch":
        assert work(a) == work(c)
        return
    assert np.array_equal(a["masked"], b["masked"])
    assert a["T"] % mix["seq_bucket"] == 0 and a["masked"].any(axis=1).all()
    pools = [[make(mix, s, i) for i in range(mix["pool_batches"])]
             for s in range(SEED, SEED + 6)]
    assert len({tuple(work(x)) for p in pools for x in p}) > 1
    assert all(sorted(w for x in p for w in work(x))
               == sorted(w for x in pools[0] for w in work(x)) for p in pools)


def test_image_tokens_and_prefix():
    mix = small("serve-batch32-hd")
    for r in make(mix, 7, 0):
        assert r["prefix_len"] == len(r["ids"]) - 1 + r["image_tokens"]
        assert (r["ids"] == traffic.IMAGE_TOKEN).sum() == 1
        assert r["views"].dtype == np.float32 and np.abs(r["views"]).max() <= 1
