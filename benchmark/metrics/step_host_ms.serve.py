"""A denoise step's host time: the host stamps of the program's `lm.step`
spans (the enqueue of a forward plus the commit), the mean over the
window's steps.  Near `step_ms.serve`, with `step_idle_ms.serve` large,
the host paces the steps."""

from _spans import named, window


def read(ctx):
    spans = window(ctx)
    steps = [] if spans is None else named(spans, "lm.step")
    if not steps:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in steps) / 1e6 / len(steps)
