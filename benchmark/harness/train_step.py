"""The training runner: back-to-back steps of the program's
`train/step.py::make_multimodal_train_step`, then its first steps held to
the plain reference.

Set-up builds one training state (the model from the seed in bf16, f32
masters and the optimizer of the mix's tunable parts), makes the pool of
batches and their masks, and drives the state through its first
`check.steps` steps on distinct batches, through the window's own call;
their losses, the first gradient as the optimizer took it (Adam's first
moment after one step, over 1 - b1) and the masters' change are kept.
Then one step on each padded length of the pool that those steps did not
meet warms every shape.  The window then steps through the pool until
`seconds` have passed and waits for the device.  Check: after the program is freed, the
reference follows the same first steps (`reference.lavida.train_steps`)."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import program, traffic
from harness.weights import Leaves
from reference import lavida as ref
from work import train as work


def program_feed(batch: dict, cfg, mix: dict, device) -> dict:
    """The step's batch as the program's collator lays it out (its
    gather plan padded to the batch's T, the views to `view_bucket`), and
    the mask."""
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan

    s = batch["samples"]
    gather_idx, text_ids, _, labels = build_gather_plan(
        cfg, [x["ids"] for x in s], [[x["views"].shape[0]] for x in s],
        [[x["size"]] for x in s], [x["labels"] for x in s],
        pad_to=batch["T"])
    pix = np.concatenate([x["views"] for x in s])
    nv = -(-pix.shape[0] // mix["view_bucket"]) * mix["view_bucket"]
    pix = np.concatenate([pix, np.zeros((nv - pix.shape[0],)
                                        + pix.shape[1:], np.float32)])
    return {"batch": {"pixel_values": torch.as_tensor(pix).to(device),
                      "text_ids": text_ids, "gather_idx": gather_idx,
                      "labels": torch.as_tensor(labels).to(device)},
            "masked": torch.as_tensor(batch["masked"]).to(device)}


def run(cell) -> dict:
    conf, mix, seed, dev = cell.conf, cell.mix, cell.seed, cell.device
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    if dev.type == "cuda":
        cell.build_s = program.build_kernels()
    model = program.build_model(conf, cell.shapes, seed, dev)
    o = mix["optimizer"]
    opt = make_freeze_optimizer(
        mix["tunable"], lr=o["lr"], b1=o["b1"], b2=o["b2"],
        weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
        schedule=o["schedule"])
    state = init_train_state(model, opt, torch.bfloat16)
    pcfg = program.port_config(conf)
    step = make_multimodal_train_step(
        pcfg, opt, remat=mix["remat"], ce_chunk=mix["ce_chunk"],
        attention_impl=mix["attention_impl"])
    pool = [traffic.train_batch(mix, cell.vcfg, seed, i)
            for i in range(mix["pool_batches"])]
    feeds = [program_feed(b, pcfg, mix, dev) for b in pool]
    K = mix["check"]["steps"]
    if K > len(pool):
        raise ValueError("the checked steps need distinct batches")
    masters0 = {n: m.detach().clone() for n, m in state.masters.items()}
    losses, grad = [], None
    for k in range(K):
        m = step(state, feeds[k]["batch"], masked_indices=feeds[k]["masked"])
        losses.append(m["loss"])
        if k == 0:
            mu = state.opt_state["groups"]["projector"]["mu"]
            grad = {n: t.float() / (1 - o["b1"]) for n, t in mu.items()}
    change = {n: (state.masters[n] - masters0[n]).norm() for n in masters0}
    prog = {"loss": [x.item() for x in losses],
            "grad": {n: v.norm().item() for n, v in grad.items()},
            "grad_vec": grad,
            "change": {n: v.item() for n, v in change.items()}}
    del masters0
    seen = {b["T"] for b in pool[:K]}
    for b, f in zip(pool, feeds):
        if b["T"] not in seen:
            seen.add(b["T"])
            step(state, f["batch"], masked_indices=f["masked"])
    setup_s = cell.setup_done()

    counts0 = program.counters()
    cell.reset_peak()
    n = 0
    with cell.recorder.window() as rec:
        t0 = time.perf_counter()
        while True:
            f = feeds[(K + n) % len(feeds)]
            with rec.item():
                step(state, f["batch"], masked_indices=f["masked"])
            n += 1
            if time.perf_counter() - t0 >= cell.seconds:
                break
        cell.sync()
        window_s = time.perf_counter() - t0
    peak = cell.peak()
    counts = {k: v - counts0[k] for k, v in program.counters().items()}
    descs = [work.step_desc(pool[(K + i) % len(pool)]) for i in range(n)]
    toks = sum(work.tokens(d) for d in descs)
    step_s = window_s / n
    out = {"attempted": n, "failed": 0,
           "e2e": {"train_tokens_per_s": toks / window_s,
                   "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
           "window_s": window_s, "peak_bytes": peak,
           "phases": [[("step", step_s)] for _ in range(n)]}
    if cell.trace:
        out["layer_ctx"] = {"items": n, "counters": counts,
                            "descs": descs}

    del step, state, model, feeds
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["check"] = compare(prog, reference(cell, pool[:K]))
    return out


def ref_batches(pool, device) -> list[dict]:
    return [{"views": [torch.as_tensor(x["views"], device=device)
                       for x in b["samples"]],
             "sizes": [x["size"] for x in b["samples"]],
             "ids": [x["ids"] for x in b["samples"]],
             "labels": [x["labels"] for x in b["samples"]],
             "T": b["T"], "masked": torch.as_tensor(b["masked"])}
            for b in pool]


def reference(cell, pool, mode: str = "f32") -> dict:
    """The reference's losses, first gradient and change over the pool's
    first batches (the mix's optimizer; `mode` "fp8" is the control)."""
    ref.exact_f32()
    W = Leaves(cell.shapes, torch.bfloat16, cell.device, cell.seed)
    lm = ref.LM(W, cell.geo, mode)
    o = cell.mix["optimizer"]
    if o["schedule"] != "constant":
        raise ValueError("the reference follows a constant LR")
    out = ref.train_steps(W, cell.vcfg, lm, ref_batches(pool, cell.device),
                          o, mode)
    del lm
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def leaf_gaps(got: dict, want: dict, keep) -> list[float]:
    """Each kept leaf's |norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's."""
    med = float(np.median([want[n] for n in keep]))
    return [abs(got[n] - want[n]) / max(want[n], med) for n in keep]


def numbers(prog: dict, want: dict) -> dict:
    """Every number the check could compare (readings.py reads them all):
    "loss" the first step's loss, relative; "grad_norm" / "change" the
    median leaf's gap of the first gradient's norm / of the masters'
    change after the checked steps (leaf_gaps); "grad" the worst leaf's
    distance from the reference's first gradient, |g - g_ref| over the
    larger of |g_ref| and the median leaf's, "grad_median" the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out."""
    med = float(np.median(list(want["grad"].values())))
    keep = [n for n, g in want["grad"].items() if g >= 1e-3 * med]
    kmed = float(np.median([want["grad"][n] for n in keep]))
    dist = [(prog["grad_vec"][n].to(want["grad_vec"][n].device)
             - want["grad_vec"][n]).norm().item()
            / max(want["grad"][n], kmed) for n in keep]
    return {"loss": abs(prog["loss"][0] - want["loss"][0])
            / abs(want["loss"][0]),
            "grad_norm": float(np.median(leaf_gaps(prog["grad"],
                                                   want["grad"], keep))),
            "change": float(np.median(leaf_gaps(prog["change"],
                                                want["change"], keep))),
            "grad": max(dist), "grad_median": float(np.median(dist))}


# the numbers compared, each against its limit (PERF.md gives the
# readings they were set from; the others have no reading of the control
# or of a fault that sets an upper end, PERF.md names them with theirs).
# The step's own `grad_norm`, over every leaf with the frozen ones, is not
# among them: the reference takes no gradient of a frozen leaf.
COMPARED = ("grad", "change")


def compare(prog: dict, want: dict) -> dict:
    got = numbers(prog, want)
    return {k: got[k] for k in COMPARED}
