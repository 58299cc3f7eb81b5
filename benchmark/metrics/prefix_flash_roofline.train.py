"""#10's share of its roofline over the traced window: each forward
launch's least time (the doubled batch's live prefix-LM pairs) and each
backward's (dq and dkv together: S recomputed, dP, dV, dQ, dK), over the
time its three kernels added to the device."""

from _common import device_s
from work import train as work


def read(ctx):
    c, descs = ctx.get("counters") or {}, ctx.get("descs")
    n = ctx.get("items")
    if not descs or not c.get("prefix_flash.fwd") or \
            c.get("prefix_flash.dq") != c.get("prefix_flash.dkv"):
        return None
    fwd, bwd = c["prefix_flash.fwd"] / n, c["prefix_flash.dq"] / n
    bound = 0.0
    for d in descs:
        b = work.prefix_flash(d, ctx["geo"])
        bound += fwd * b["fwd"][0] + bwd * b["bwd"][0]
    t = device_s(ctx, r"prefix_flash_(fwd|dq|dkv)_kernel")
    return None if t is None else 100.0 * bound / t
