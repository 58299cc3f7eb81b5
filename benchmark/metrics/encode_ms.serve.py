"""The vision layer's wall per batch: `generate_batch`'s `encode` wall
(host clock ending in a device sync), averaged over the window's batches."""


def read(ctx):
    walls = ctx.get("walls")
    if not walls:
        return None
    return 1e3 * sum(w["encode"] for w in walls) / len(walls)
