"""Tiny cells for the CPU tests: a copy of the benchmark tree in a
temporary checkout with a tiny configuration of each family, tiny mixes
of both kinds and a manifest of their own (the program's kernels run their
plain versions on the CPU)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

PINS = [[56, 112], [112, 56], [112, 112], [168, 56], [56, 168]]
VISION = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 3,
          "num_attention_heads": 4, "num_channels": 3, "image_size": 56,
          "patch_size": 14, "layer_norm_eps": 1e-06,
          "hidden_act": "gelu_pytorch_tanh"}


def tiny_config(family: str) -> dict:
    base = json.loads((BENCH / "configs" / (
        "lavida-llada-8b.json" if family == "llada"
        else "lavida-dream-7b.json")).read_text())
    c = copy.deepcopy(base)
    c["name"] = f"tiny-{family}"
    c["vision"] = dict(VISION)
    c["composition"] = dict(c["composition"], mm_hidden_size=32,
                            image_grid_pinpoints=PINS)
    if family == "llada":
        c.update(d_model=128, n_heads=4, n_kv_heads=4, n_layers=2,
                 mlp_hidden_size=256, vocab_size=512, embedding_size=512,
                 max_sequence_length=512, rope_theta=10000.0,
                 mask_token_id=500, eos_token_id=501, pad_token_id=501)
    else:
        c.update(hidden_size=128, intermediate_size=256,
                 num_attention_heads=4, num_key_value_heads=2,
                 num_hidden_layers=2, vocab_size=512,
                 max_position_embeddings=512, rope_theta=10000.0,
                 mask_token_id=500, eos_token_id=501, pad_token_id=501)
    return c


SERVE = {"kind": "serve_batch", "batch": 6,
         "image_sizes": [[100, 60], [60, 100], [112, 112]],
         "prompt_tokens": [10, 16], "marker_after": 8, "text_ids": [3, 400],
         "pool_batches": 2,
         "gen": {"max_new_tokens": 16, "block_length": 16, "step_per_block": 8,
                 "temperature": 0.0, "remasking": "low_confidence",
                 "prefix_lm": True},
         "prefix_bucket": 16, "layout": "int4", "fuse": False, "kv8": False,
         "check": {"requests": 6}}

# view_bucket 1: these sizes give 9 views, and a padded view count puts
# pad views' features in the text rows (the program fault of PERF.md §7)
TRAIN = {"kind": "train_step", "batch": 2,
         "image_sizes": [[100, 60], [112, 112]], "prompt_tokens": 4,
         "caption_tokens": [5, 9], "text_ids": [3, 400], "seq_bucket": 16,
         "view_bucket": 1, "pool_batches": 3, "mask_eps": 0.001,
         "tunable": "mm_mlp_adapter",
         "optimizer": {"lr": 0.001, "b1": 0.9, "b2": 0.999, "eps": 1e-08,
                       "weight_decay": 0.0, "grad_clip": 1.0,
                       "schedule": "constant"},
         "remat": "whole_layer", "attention_impl": "dense", "ce_chunk": 16,
         "check": {"steps": 2}}

CELLS = {"tiny-serve": ("tiny-llada", "tiny-serve"),
         "tiny-train": ("tiny-llada", "tiny-train"),
         "tiny-dream-train": ("tiny-dream", "tiny-train")}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """A checkout at `tmp` holding a copy of the benchmark tree with the
    tiny configurations, mixes, cells and limits."""
    bench = tmp / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for fam in ("llada", "dream"):
        (bench / "configs" / f"tiny-{fam}.json").write_text(
            json.dumps(tiny_config(fam)))
    (bench / "traffic" / "tiny-serve.json").write_text(json.dumps(SERVE))
    (bench / "traffic" / "tiny-train.json").write_text(json.dumps(TRAIN))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"] = [{"name": f"tiny-{f}", "source": "tiny",
                       "file": f"benchmark/configs/tiny-{f}.json",
                       "reduced": [], "why": "tiny"}
                      for f in ("llada", "dream")]
    man["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                         "why": "tiny"} for n, (c, t) in CELLS.items()]
    for m in man["end_to_end"] + man["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    # set from CPU readings at this size (benchmark/readings.py --device
    # cpu): sound runs read gap <= 0.009, grad <= 6.3e-3, change <= 4.6e-3;
    # the controls gap >= 0.05, grad >= 5.7e-2; the faults grad >= 0.6
    # (half) and change 1.0 (frozen)
    lim = {"tiny-serve": {"gap": 0.025},
           "tiny-train": {"grad": 0.02, "change": 2e-2},
           "tiny-dream-train": {"grad": 0.02, "change": 2e-2}}
    lim.update(limits or {})
    for n, v in lim.items():
        (bench / "limits" / f"{n}.json").write_text(json.dumps(v))
    return tmp
