#!/usr/bin/env python3
"""The readings a cell's limits are set from (not part of a benchmark
run): the program's compared numbers on several seeds, the control's (the
plain reference in the nearest lower precision, put in the program's
place) and the faults' (the timed path broken underneath), at the cell's
own size, one process for all:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--control] [--fault NAME ...]

Serving: the control is the reference with int4 activations ("w4a4") in
place of int8 read at the program's own states; the fault "token" alters
one committed token a step where it is produced.  Training: the control
is the reference in fp8 (e4m3, a scale a tensor) compared as the program
is; the faults are "frozen" (an optimizer step that leaves the state
unchanged) and "half" (half of the batch left out, the mean over the
rest).  Each reading is one JSON line on standard output."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


@contextlib.contextmanager
def fault(name: str | None):
    """The program's timed path with one fault planted underneath."""
    if name is None:
        yield
        return
    import torch

    if name == "token":
        from lavida_mod_tpu_torch.ops import sampling

        orig = sampling.denoise_commit

        def commit(x, logits, mask_index, *a, **kw):
            out = orig(x, logits, mask_index, *a, **kw)
            new = (out != x) & mask_index
            first = torch.argmax(new.int(), dim=1)
            rows = torch.arange(out.shape[0], device=out.device)
            bad = out.clone()
            bad[rows, first] = (out[rows, first] + 1) % 100 + 3
            return torch.where(new.any(dim=1)[:, None], bad, out)

        sampling.denoise_commit = commit
        try:
            yield
        finally:
            sampling.denoise_commit = orig
    elif name == "frozen":
        from lavida_mod_tpu_torch.train import step as st

        orig = st.AdamW.apply
        st.AdamW.apply = lambda self, grads, state, params: None
        try:
            yield
        finally:
            st.AdamW.apply = orig
    elif name == "half":
        from lavida_mod_tpu_torch.train import step as st

        orig = st.diffusion_loss

        def half(lm, embeds, labels, generator=None, **kw):
            B = embeds.shape[0] // 2 or 1
            mi = kw.pop("masked_indices", None)
            return orig(lm, embeds[:B], labels[:B], generator,
                        masked_indices=None if mi is None else mi[:B], **kw)

        st.diffusion_loss = half
        try:
            yield
        finally:
            st.diffusion_loss = orig
    else:
        raise SystemExit(f"no fault {name!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    a = ap.parse_args(argv)
    from pathlib import Path

    from harness import serve_batch, train_step
    from harness.main import run_cell

    root = Path(a.root)
    for seed in [int(s) for s in a.seeds.split(",")]:
        for name in [None] + a.fault:
            extra = {}
            if a.control and name is None:
                orig_check = serve_batch.check
                orig_ref = train_step.reference

                def check(cell, pairs, control=False):
                    r = orig_check(cell, pairs, control=True)
                    extra.update(r)
                    return r

                def reference(cell, pool, mode="f32"):
                    want = orig_ref(cell, pool, mode)
                    ctl = orig_ref(cell, pool, "fp8")
                    extra.update({f"control_{k}": v for k, v in
                                  train_step.numbers(ctl, want).items()})
                    return want

                serve_batch.check = check

                train_step.reference = reference
            raw = {}
            orig_compare = train_step.compare

            def compare(prog, want):
                raw.update(train_step.numbers(prog, want))
                return orig_compare(prog, want)

            train_step.compare = compare
            t0 = time.perf_counter()
            try:
                with fault(name):
                    res, _ = run_cell(root, a.workload, seed, a.seconds,
                                      False, a.device)
            finally:
                train_step.compare = orig_compare
                if a.control and name is None:
                    serve_batch.check = orig_check
                    train_step.reference = orig_ref
            row = {"workload": a.workload, "seed": seed, "fault": name,
                   "correct": res["correct"],
                   "check": {k: v["value"] for k, v in res["check"].items()},
                   **({"control": extra} if extra else {}),
                   **({"numbers": raw} if raw else {}),
                   "device": res["device"]["kind"],
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
