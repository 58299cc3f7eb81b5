#!/usr/bin/env python3
"""Time the stage-1 training step of a checkout on one CUDA card, with the
device time of one profiled step grouped by kernel kind:

    python3 lavida_mod_tpu_torch/step_times.py [CHECKOUT]

CHECKOUT is the root of a tree that holds `chip_smoke.py` and its
`lavida_mod_tpu_torch` package (default: the tree holding this file).  The
script runs that tree's own stage-1 phase (`chip_smoke.phase_stage1`: full
LaViDa-LLaDA-8B, a warm-up step and three timed steps, its checks, then
one step under torch.profiler), so two trees are timed by their own code
in turns on one card, one process each; only the profiler's report is
replaced, by the sums of `by_kind`.  chip_smoke.py groups its own profiled
step the same way.
"""

from __future__ import annotations

import os
import re
import sys
import time

# kernel kinds by name, the first match wins
KINDS = (
    ("prefix_flash", r"prefix_flash"),
    ("short_attention", r"short_attention"),
    ("gemm", r"nvjet|gemm|cutlass|xmma|sm90_|Kernel2"),
    ("copy/cast", r"copy|cast"),
    ("elementwise", r"elementwise|Functor|vectorized"),
    ("reduce", r"reduce|Reduce|norm"),
    ("index", r"index|scatter|gather|embedding"),
)


def by_kind(rows) -> dict:
    """{kind: [device ms, launches]} of the profiler rows (name, ms,
    count), kinds by `KINDS`, the rest under "other"."""
    out = {}
    for key, ms, n in rows:
        kind = next((k for k, pat in KINDS if re.search(pat, key)), "other")
        acc = out.setdefault(kind, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def print_by_kind(tag: str, rows, what: str) -> None:
    for kind, (ms, n) in by_kind(rows).items():
        print(f"[{tag}] device time of {what}: {kind:16s} {ms:9.2f} ms "
              f"in {n:6d} launches")


def main(argv: list[str]) -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(argv[0] if argv else os.path.dirname(here))
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("step_times.py needs a CUDA device")
    import chip_smoke

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != tree:
        raise RuntimeError(f"chip_smoke came from {chip_smoke.__file__}")
    from torch.profiler import ProfilerActivity, profile

    def profile_busy(torch, run):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(r[1] for r in rows)
        print(f"[steps] {tree}: one profiled step, device busy {busy:.1f} "
              f"ms of a {wall:.1f} ms wall")
        print_by_kind("steps", rows, "the profiled step")
        rows.sort(key=lambda r: -r[1])
        return busy, wall, rows[:12], rows

    # the tree's own phase, with this report in place of its profile print
    chip_smoke._profile_busy = profile_busy
    chip_smoke._print_profile = lambda tag, prof, what, card: prof[0] / prof[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_stage1(torch, torch.device("cuda", 0),
                            chip_smoke.card_line())


if __name__ == "__main__":
    main(sys.argv[1:])
