"""Device time per step of the elementwise and copy / cast kernels."""

from _common import kind_s


def read(ctx):
    s = kind_s(ctx, ("elementwise", "copy/cast"))
    return None if not s else 1e3 * s / ctx["items"]
