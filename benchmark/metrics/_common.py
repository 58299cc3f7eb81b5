"""Shared arithmetic of the per-layer readers (not a metric: the harness
loads `<metric>.py` by a metric's name only)."""

import re


def device_s(ctx, pattern: str):
    """Seconds the traced window's kernels matching `pattern` added to the
    device's busy time; None without a device trace."""
    tr = ctx.get("trace")
    if not tr or not tr["by_name"]:
        return None
    s = sum(v[0] for n, v in tr["by_name"].items() if re.search(pattern, n))
    return s if s > 0 else None


def kind_s(ctx, kinds):
    tr = ctx.get("trace")
    if not tr or not tr["by_kind"]:
        return None
    return sum(tr["by_kind"].get(k, [0.0])[0] for k in kinds)


def idle_share(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
