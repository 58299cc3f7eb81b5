"""#4's share of its roofline over the traced window: the least time of
every launch the traffic's shapes ask for (work/serve.py), over the time
#4's kernels (row quantization, decode and prefill GEMMs) added to the
device.  Silent when the program's launches are not the ones counted."""

from _common import device_s


def read(ctx):
    w = (ctx.get("work") or {}).get("w4_grouped")
    if not w or ctx["counters"].get("w4_grouped") != w["launches"]:
        return None
    t = device_s(ctx, r"w4_(decode|prefill)_kernel|row_quant_kernel")
    return None if t is None else 100.0 * w["bound_s"] / t
