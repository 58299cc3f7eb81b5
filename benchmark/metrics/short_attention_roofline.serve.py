"""#1's share of its roofline over the traced window (the tower's and the
prefill's launches, their live pairs from the traffic's shapes), over the
time #1's bf16 kernel added to the device."""

from _common import device_s


def read(ctx):
    w = (ctx.get("work") or {}).get("short_attention")
    if not w or ctx["counters"].get("short_attention") != w["launches"]:
        return None
    t = device_s(ctx, r"short_attention_kernel")
    return None if t is None else 100.0 * w["bound_s"] / t
