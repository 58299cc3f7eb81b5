"""The steps' model operations (work/train.py: forward, backward with
every leaf's weight gradient, no remat recompute) at 989 TFLOP/s bf16,
over the traced window."""

from work import counts, train as work


def read(ctx):
    descs = ctx.get("descs")
    if not descs or not ctx.get("trace") or not ctx["trace"]["busy_s"]:
        return None
    ops = sum(work.model_ops(d, ctx["geo"], ctx["vcfg"]) for d in descs)
    return 100.0 * ops / counts.PEAK["bf16"] / ctx["window_s"]
