"""The batches' model work at the chip's peaks (W4A8 products at 1,979
TOP/s, bf16 at 989 TFLOP/s, unpadded rows), over the traced window."""


def read(ctx):
    w = ctx.get("work")
    if not w or not ctx.get("trace") or not ctx["trace"]["busy_s"]:
        return None
    return 100.0 * w["model_s"] / ctx["window_s"]
