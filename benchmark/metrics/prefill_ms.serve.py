"""The chunked prefill's device time per batch: the CUDA events of the
program's `lm.prefill` span (`generation/diffusion.py::prefill_cache`),
summed over the window's batches and divided by their number."""

from _spans import device_ms, window


def read(ctx):
    spans = window(ctx)
    ms = None if spans is None else device_ms(spans, "lm.prefill")
    return None if ms is None else sum(ms) / ctx["items"]
