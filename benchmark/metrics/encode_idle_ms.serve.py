"""The device's idle time per batch in the vision layer: the traced
window's stretches with no device activity whose midpoint lies in a
request's `vision.encode` span (on the shared clock), summed and divided
by the window's batches."""

from _spans import idle_under, window


def read(ctx):
    spans = window(ctx)
    got = None if spans is None else idle_under(ctx, spans, "vision.encode")
    if not got or not got[1]:
        return None
    return 1e3 * got[0] / ctx["items"]
