"""Profiling: the port of lavida_mod_tpu/utils/profiling.py.

`trace(log_dir)` records the CPU and, where there is a card, the CUDA
activity of its block with torch.profiler and writes a Chrome trace,
`<log_dir>/trace.json` (open it in chrome://tracing or Perfetto); it
stands where the JAX package starts jax.profiler.  The object it yields
gets, on exit, `path`, `wall_ms` (host clock over the block, after a
device sync) and `busy_ms`, the union of the CUDA kernels' intervals
(kernel_times.added_times), None on the CPU or when the trace holds no
device time.  `StageTimer` accumulates wall time per named stage, with a
device sync before each reading so that queued kernels are counted.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class Trace:
    path: str
    wall_ms: float = 0.0
    busy_ms: Optional[float] = None

    @property
    def busy_share(self) -> Optional[float]:
        return None if self.busy_ms is None else self.busy_ms / self.wall_ms


@contextlib.contextmanager
def trace(log_dir: str = "lavida_trace"):
    """`with trace('dir') as t: run()`; then t.busy_share."""
    from torch.profiler import ProfilerActivity, profile

    from ..kernel_times import added_times

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Trace(os.path.join(log_dir, "trace.json"))
    with profile(activities=acts) as prof:
        _sync()
        t0 = time.perf_counter()
        yield out
        _sync()
        out.wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(out.path)
    busy = sum(r[0] for r in added_times(torch, prof).values())
    out.busy_ms = busy if busy > 0 else None


class StageTimer:
    """Accumulating per-stage wall timer; each reading follows a device
    sync."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kw):
        with self.stage(name):
            out = fn(*args, **kw)
        return out

    def summary(self) -> dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v * 1e3:.1f}ms"
                          for k, v in self.summary().items())
