"""The device's idle time per denoise step: the traced window's stretches
with no device activity whose midpoint lies in a `lm.step` span (on the
shared clock), summed and divided by the window's steps."""

from _spans import idle_under, window


def read(ctx):
    spans = window(ctx)
    got = None if spans is None else idle_under(ctx, spans, "lm.step")
    if not got or not got[1]:
        return None
    return 1e3 * got[0] / got[1]
