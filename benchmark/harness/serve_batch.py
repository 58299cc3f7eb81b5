"""The batched serving runner: a closed loop of batches through the
program's `eval/adapter.py::generate_batch`, then the served tokens held
to the plain reference.

Set-up: the kernels, the model from the seed in bf16, the serving layout,
the pool of batches, one warm-up batch (every shape of the cell: the pool's
batches all bucket to the same prefix rows).  Window: batches back to
back until `seconds` have passed; it ends at a batch boundary and is timed
to it (generate_batch returns host tokens, so each batch ends in a device
sync).  Check: after the window and the program freed, a sample of the
served requests drawn from the seed, the longest prompt among them, each
followed by the reference (`reference.lavida.served_gaps`)."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import program, traffic
from harness.weights import Leaves
from reference import lavida as ref
from work import serve as work


class Steps:
    """Keeps the answer tokens after every denoise step of the program's
    generation (its `ops/sampling.py::denoise_commit`, wrapped: a copy of
    the [B, G] result a step, left on the device), so the check can hold
    each step to the reference in the state the program was in."""

    def __init__(self):
        from lavida_mod_tpu_torch.ops import sampling

        self.mod, self.orig, self.batches = sampling, sampling.denoise_commit, []

        def commit(x, *a, **kw):
            out = self.orig(x, *a, **kw)
            if not self.batches[-1]:
                self.batches[-1].append(x.clone())
            self.batches[-1].append(out.clone())
            return out

        sampling.denoise_commit = commit

    def new_batch(self) -> None:
        self.batches.append([])

    def close(self) -> None:
        self.mod.denoise_commit = self.orig

    def states(self, b: int, row: int):
        """[S + 1, G] of request `row` of batch `b`."""
        import torch

        return torch.stack([t[row] for t in self.batches[b]])


def requests_of(batch):
    return [(r["ids"], [r["views"]], [r["size"]]) for r in batch]


def generation(mix: dict):
    from lavida_mod_tpu_torch.config import GenerationConfig

    return GenerationConfig(**mix["gen"])


def run(cell) -> dict:
    conf, mix, seed, dev = cell.conf, cell.mix, cell.seed, cell.device
    from lavida_mod_tpu_torch.eval.adapter import generate_batch

    if dev.type == "cuda":
        cell.build_s = program.build_kernels()
    model = program.build_model(conf, cell.shapes, seed, dev)
    model.to_serving_layout(mix["layout"], fuse=mix["fuse"])
    pool = [traffic.serve_batch(mix, cell.vcfg, seed, i)
            for i in range(mix["pool_batches"])]
    gen = generation(mix)
    kw = dict(prefix_bucket=mix["prefix_bucket"], kv8=mix["kv8"])
    generate_batch(model, requests_of(pool[0]), gen, **kw)      # warm-up
    cell.sync()
    setup_s = cell.setup_done()

    served, walls = [], []
    steps = Steps()
    counts0 = program.counters()
    cell.reset_peak()
    with cell.recorder.window() as rec:
        t0 = time.perf_counter()
        while True:
            i = len(walls)
            steps.new_batch()
            with rec.item():
                out, wall = generate_batch(model, requests_of(
                    pool[i % len(pool)]), gen, **kw)
            served.append(out)
            walls.append(wall)
            if time.perf_counter() - t0 >= cell.seconds:
                break
        window_s = time.perf_counter() - t0
    steps.close()
    peak = cell.peak()
    counts = {k: v - counts0[k] for k, v in program.counters().items()}
    n = len(walls)
    B = mix["batch"]
    out = {"attempted": n * B, "failed": 0,
           "e2e": {"images_per_s": n * B / window_s, "setup_s": setup_s,
                   "peak_mem_gib": peak / 2 ** 30},
           "window_s": window_s, "peak_bytes": peak,
           "phases": [[("encode", w["encode"]), ("generate", w["generate"])]
                      for w in walls]}
    if cell.trace:
        descs = [work.batch_desc(pool[i % len(pool)], mix, cell.geo)
                 for i in range(n)]
        out["layer_ctx"] = {
            "items": n, "walls": walls, "counters": counts,
            "work": work.window_work(descs, cell.geo, cell.vcfg)}

    # the check: the program freed, then the reference
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = traffic.rng_for(seed, 3)
    order = rng.permutation(n * B)
    pick = list(order[:mix["check"]["requests"]])
    every = [(k // B, k % B) for k in range(n * B)]
    longest = max(range(n * B), key=lambda k: pool[every[k][0] % len(pool)]
                  [every[k][1]]["prefix_len"])
    if longest not in pick:
        pick[-1] = longest
    pairs = []
    for k in pick:
        b, row = every[k]
        st = steps.states(b, row).cpu()
        if not np.array_equal(st[-1].numpy(), served[b][row]):
            st = st[:1]                 # not what was served: fails
        pairs.append((pool[b % len(pool)][row], st))
    del steps
    gaps = check(cell, pairs)
    out["check"] = {"gap": gaps["gap"]}
    return out


def check(cell, pairs, control: bool = False) -> dict:
    """The widest gaps over `pairs` of (request, its states [S + 1, G])
    (`reference.lavida.served_gaps`); with `control`, the w4a4
    control's too."""
    ref.exact_f32()
    W = Leaves(cell.shapes, torch.bfloat16, cell.device, cell.seed)
    with torch.no_grad():
        vision = ref.Vision(W, cell.vcfg, "f32")
        lm = ref.LM(W, cell.geo, "w4a8")
        ctl = "w4a4" if control else None
        k_steps = work.steps_of(cell.mix)
        worst = {}
        for r, st in pairs:
            views = torch.as_tensor(r["views"], device=cell.device)
            block = ref.merge_image(vision.features(views), r["size"],
                                    cell.vcfg, W("image_newline").float())
            prefix = ref.splice(r["ids"], [block], lm.wte)
            g = ref.served_gaps(lm, prefix, st.to(cell.device), k_steps, ctl)
            for key, v in g.items():
                if v is not None:
                    worst[key] = max(worst.get(key, 0.0), v)
    return worst
