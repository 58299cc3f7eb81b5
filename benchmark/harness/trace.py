"""The traced window: torch.profiler over the window, and what the
per-layer readers and the result's `breakdown` read from it.

Device busy time is the union of the device activity's intervals (what
each kernel adds after the end of every one before it: the arithmetic of
`lavida_mod_tpu_torch/kernel_times.py::added_times`, copied), so kernels
that overlap under programmatic dependent launch are not counted twice.
Kernel kinds by name follow `lavida_mod_tpu_torch/step_times.py::KINDS`
(copied).  Idle gaps are labelled by the harness's own span that held
them: each item of the window is one `bench.item` range on the host,
split into the phases its runner names (encode / generate, step).
"""

from __future__ import annotations

import contextlib
import re

ITEM = "bench.item"

# kernel kinds by name, the first match wins (step_times.py's KINDS)
KINDS = (
    ("prefix_flash", r"prefix_flash"),
    ("short_attention", r"short_attention"),
    ("gemm", r"nvjet|gemm|cutlass|xmma|sm90_|Kernel2"),
    ("copy/cast", r"copy|cast|Memcpy|Memset"),
    ("elementwise", r"elementwise|Functor|vectorized"),
    ("reduce", r"reduce|Reduce|norm"),
    ("index", r"index|scatter|gather|embedding"),
)


def kind_of(name: str) -> str:
    return next((k for k, pat in KINDS if re.search(pat, name)), "other")


def union_busy(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    busy, done = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy += max(end - max(start, done), 0.0)
        done = max(done, end)
    return busy / 1e6


def idle_gaps(intervals, lo: float, hi: float):
    """(start_us, end_us) of every stretch in [lo, hi] that no interval
    covers."""
    gaps, done = [], lo
    for start, end in sorted(intervals):
        if start > done:
            gaps.append((done, min(start, hi)))
        done = max(done, end)
        if done >= hi:
            break
    if done < hi:
        gaps.append((done, hi))
    return [(a, b) for a, b in gaps if b > a]


class Recorder:
    """Profiles the window when `on`; `item()` marks one item on the
    host."""

    def __init__(self, on: bool):
        self.on, self.prof = on, None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield self
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield self
        self.prof = prof

    def item(self):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(ITEM)

    def read(self, phases) -> dict:
        """What the readers take from the trace.  `phases`: per item, the
        [(name, seconds), ...] its runner measured on the host clock, in
        order.  Returns {"kernels": [(name, start_us, end_us)], "busy_s",
        "span_s" (first item's start to the last one's end), "by_name":
        {name: [seconds added, launches]}, "by_kind", "gaps": [(label,
        seconds)] longest first}.  A kernel's seconds are those it adds
        to the union (kernel_times.added_times)."""
        import torch

        # the raw activity records (building the profiler's event tree
        # takes minutes over a serving window); times in us
        kern, items = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    kern.append((e.name(), e.start_ns() / 1e3,
                                 e.end_ns() / 1e3))
            elif e.name() == ITEM:
                items.append((e.start_ns() / 1e3, e.end_ns() / 1e3))
        items.sort()
        by_name: dict = {}
        done = float("-inf")
        for name, a, b in sorted(kern, key=lambda k: k[1]):
            # seconds each kernel adds past the end of every one before it
            r = by_name.setdefault(name, [0.0, 0])
            r[0] += max(b - max(a, done), 0.0) / 1e6
            r[1] += 1
            done = max(done, b)
        if not kern:
            return {"kernels": [], "busy_s": 0.0, "span_s": 0.0,
                    "by_name": {}, "by_kind": {}, "gaps": []}
        by_kind: dict = {}
        for name, (s, n) in by_name.items():
            r = by_kind.setdefault(kind_of(name), [0.0, 0])
            r[0] += s
            r[1] += n
        spans = [(a, b) for _, a, b in kern]
        lo = items[0][0] if items else min(a for a, _ in spans)
        # the window runs to the end of its last item or of the device
        # work it queued, whichever is later
        hi = max([b for _, b in spans] + [b for _, b in items])
        inside = [(max(a, lo), min(b, hi)) for a, b in spans
                  if b > lo and a < hi]
        labelled = []
        for a, b in idle_gaps(inside, lo, hi):
            labelled.append((_label((a + b) / 2, items, phases), (b - a) / 1e6))
        labelled.sort(key=lambda g: -g[1])
        return {"kernels": kern, "busy_s": union_busy(inside),
                "span_s": (hi - lo) / 1e6, "by_name": by_name,
                "by_kind": by_kind, "gaps": labelled}


def _label(t: float, items, phases) -> str:
    for (a, b), ph in zip(items, phases):
        if a <= t <= b:
            at = a
            for name, s in ph:
                at += s * 1e6
                if t <= at:
                    return name
            return ph[-1][0] if ph else "item"
    return "between"
