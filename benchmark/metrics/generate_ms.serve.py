"""The LM and generation layer's wall per batch: `generate_batch`'s
`generate` wall (the chunked prefill and the denoise steps), averaged over
the window's batches."""


def read(ctx):
    walls = ctx.get("walls")
    if not walls:
        return None
    return 1e3 * sum(w["generate"] for w in walls) / len(walls)
