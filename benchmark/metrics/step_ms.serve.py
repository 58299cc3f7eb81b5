"""A denoise step's device time: the CUDA events of the program's
`lm.step` spans (every denoise loop of `generation/diffusion.py`), the
mean over the window's steps."""

from _spans import device_ms, window


def read(ctx):
    spans = window(ctx)
    ms = None if spans is None else device_ms(spans, "lm.step")
    return None if ms is None else sum(ms) / len(ms)
