"""Profiling: the port of lavida_mod_tpu/utils/profiling.py.

`trace(log_dir)` records the CPU and, where there is a card, the CUDA
activity of its block with torch.profiler and writes a Chrome trace,
`<log_dir>/trace.json` (open it in chrome://tracing or Perfetto); it
stands where the JAX package starts jax.profiler.  The object it yields
gets, on exit, `path`, `wall_ms` (host clock over the block, after a
device sync) and `busy_ms`, the union of the CUDA kernels' intervals
(kernel_times.added_times), None on the CPU or when the trace holds no
device time.

`span(name, row=None, device=False)` marks a stretch of the program (the
serving path's layers: `serve.batch`, `vision.encode`, `lm.prefill`,
`lm.step`, ...).  It records only while a torch.profiler records (inside
`trace()` or any other profile); otherwise it is one shared no-op context
that allocates nothing and touches no device.  When on, a span opens a
`record_function` of its name (so Chrome traces show it) and keeps, in a
bounded in-memory list read by `spans()`: its name, its id, its parent's
id (the innermost span open on the thread), its root's id (the outermost),
the request's row in a batch, host stamps in Unix nanoseconds
(`time.time_ns()`, the clock of the profiler's own events, so a span
lines up with the trace's kernels even when the profiler records no CPU
activity) and, with `device=True`, a CUDA event pair on the current
stream.  Nothing on the hot path syncs the device: the events become
milliseconds when `spans()` reads them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
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


# the spans kept: the newest, at most this many
CAP = 1 << 16
_records: collections.deque = collections.deque(maxlen=CAP)
_ids = itertools.count(1)
_open = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "fn")

    def __init__(self, name: str, row: Optional[int], device: bool):
        stack = _open.__dict__.setdefault("stack", [])
        sid = next(_ids)
        parent = stack[-1] if stack else None
        # [name, id, parent, root, row, start_ns, end_ns, events]
        self.rec = [name, sid, parent[1] if parent else None,
                    parent[3] if parent else sid, row, 0, 0,
                    device and torch.cuda.is_initialized()]
        self.fn = torch.profiler.record_function(name)

    def __enter__(self):
        rec = self.rec
        self.fn.__enter__()
        _open.stack.append(rec)
        if rec[7]:
            rec[7] = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            rec[7][0].record()
        rec[5] = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[6] = time.time_ns()
        if rec[7]:
            rec[7][1].record()
        _open.stack.pop()
        _records.append(rec)
        self.fn.__exit__(*exc)
        return False


def span(name: str, *, row: Optional[int] = None, device: bool = False):
    """A context marking `name` while a torch.profiler records (see the
    module's docstring); row: the request's row in its batch; device: a
    CUDA event pair brackets the span on the current stream."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, row, device)


def spans() -> list[dict]:
    """The spans kept, in the order they closed: {"name", "id", "parent",
    "root", "row", "start_ns", "end_ns", "device_ms"} ("parent" None at a
    root; "device_ms" the CUDA events' elapsed time, None without them).
    Waits for the device where a span's end event is still queued."""
    out = []
    for name, sid, parent, root, row, t0, t1, ev in list(_records):
        ms = None
        if ev:
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1])
        out.append({"name": name, "id": sid, "parent": parent, "root": root,
                    "row": row, "start_ns": t0, "end_ns": t1,
                    "device_ms": ms})
    return out


def clear() -> None:
    """Forget every span kept."""
    _records.clear()
