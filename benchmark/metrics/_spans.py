"""Shared arithmetic of the readers of the program's spans
(`lavida_mod_tpu_torch/utils/profiling.py::spans`, recorded while the
harness's profiler runs; not a metric: the harness loads `<metric>.py` by
a metric's name only).

A span's host stamps are Unix nanoseconds, the clock of the trace's
kernels (microseconds there), so a stretch in which the device ran
nothing is put down to the innermost span the host was in at the
stretch's midpoint.  Every reader returns None where the program records
no spans (a program without them), and where what it reads is missing
(CUDA events or kernels, on the CPU)."""

from bisect import bisect_right

from harness.trace import idle_gaps

ROOT = "serve.batch"


def window(ctx):
    """The window's spans: the last `ctx["items"]` `serve.batch` roots
    and their descendants; None without them."""
    from lavida_mod_tpu_torch.utils import profiling

    read, n = getattr(profiling, "spans", None), ctx.get("items")
    if read is None or not n:
        return None
    spans = read()
    roots = [s for s in spans if s["name"] == ROOT and s["parent"] is None]
    if len(roots) < n:
        return None
    keep = {s["id"] for s in roots[-n:]}
    return [s for s in spans if s["root"] in keep]


def named(spans, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def device_ms(spans, name: str):
    """The CUDA-event milliseconds of each span named `name`; None where
    there are none or one lacks its events."""
    ms = [s["device_ms"] for s in named(spans, name)]
    return ms if ms and None not in ms else None


def innermost(spans):
    """(cuts, owners): the host timeline (us) cut wherever a span opens or
    closes; owners[i] is the innermost span open from cuts[i] to
    cuts[i + 1], None where none is.  Spans nest, as on one thread."""
    cuts, owners, stack = [], [], []

    def close_until(t):
        while stack and stack[-1]["end_ns"] <= t:
            top = stack.pop()
            cuts.append(top["end_ns"] / 1e3)
            owners.append(stack[-1] if stack else None)

    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        close_until(s["start_ns"])
        stack.append(s)
        cuts.append(s["start_ns"] / 1e3)
        owners.append(s)
    close_until(float("inf"))
    return cuts, owners


def idle_by_span(kernels, spans, lo: float, hi: float) -> dict:
    """{span id, or None: idle seconds}: every stretch of [lo, hi] (us) in
    which none of the (name, start_us, end_us) kernels ran, put down to
    the innermost span holding its midpoint.  The values sum to the
    stretch's seconds less the kernels' union (harness.trace.union_busy)."""
    inside = [(max(a, lo), min(b, hi)) for _, a, b in kernels
              if b > lo and a < hi]
    cuts, owners = innermost(spans)
    idle: dict = {}
    for a, b in idle_gaps(inside, lo, hi):
        i = bisect_right(cuts, (a + b) / 2) - 1
        owner = owners[i]["id"] if i >= 0 and owners[i] else None
        idle[owner] = idle.get(owner, 0.0) + (b - a) / 1e6
    return idle


def idle_under(ctx, spans, name: str):
    """Idle seconds put down to the spans named `name` and to their
    descendants, over the window's batches (the first root's start to the
    last one's end), and the number of such spans; None without a device
    trace."""
    tr = ctx.get("trace")
    if not tr or not tr["kernels"]:
        return None
    roots = named(spans, ROOT)
    lo = min(s["start_ns"] for s in roots) / 1e3
    hi = max(s["end_ns"] for s in roots) / 1e3
    idle = idle_by_span(tr["kernels"], spans, lo, hi)
    by_id = {s["id"]: s for s in spans}

    def under(sid):
        while sid is not None:
            if by_id[sid]["name"] == name:
                return True
            sid = by_id[sid]["parent"]
        return False

    return (sum(v for sid, v in idle.items() if under(sid)),
            len(named(spans, name)))
