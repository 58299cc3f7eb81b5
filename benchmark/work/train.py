"""The work of the stage-1 training cells, per step, from the traffic's
shapes: #10's launches (the prefix-LM flash attention over the doubled
batch's padded rows) and the step's model operations for `mfu.train`.

`mfu.train` counts, over unpadded rows: the forward (tower, projector,
the LM over both halves of the complementary batch, the head at every
row), the backward with a weight gradient for every leaf that the step's
`grad_norm` covers (all of them: the program's train/step.py takes the
frozen leaves' norms too), attention at its mask's live pairs; not the
remat recompute."""

from __future__ import annotations

from work import counts as C


def step_desc(batch: dict) -> dict:
    s = batch["samples"]
    return {"B": len(s), "T": batch["T"],
            "L": [x["length"] for x in s],
            "prefix": [x["prefix_len"] for x in s],
            "views": [x["views"].shape[0] for x in s]}


def tokens(d: dict) -> int:
    """Unpadded tokens of one step's samples."""
    return sum(d["L"])


def prefix_flash(d: dict, geo: dict) -> dict:
    """One forward launch's and one backward's (dq + dkv) least seconds
    over the doubled batch [2B, T] (every padded row is a live query past
    the prefix, so the mask's live pairs are counted over T)."""
    hd = geo["D"] // geo["H"]
    pairs = 2 * sum(C.prefix_pairs(d["T"], p) for p in d["prefix"])
    B2 = 2 * d["B"]
    fwd = C.bound_s(*C.attention_fwd(pairs, geo["H"], hd, geo["Hkv"],
                                     d["T"], d["T"], B2), "bf16")
    bwd = C.bound_s(*C.attention_bwd(pairs, geo["H"], hd, geo["Hkv"],
                                     d["T"], B2), "bf16")
    return {"fwd": fwd, "bwd": bwd}


def model_ops(d: dict, geo: dict, vcfg: dict) -> float:
    """bf16 operations of one step (module note)."""
    ops = 0.0
    for L, p, V in zip(d["L"], d["prefix"], d["views"]):
        t = C.tower_forward_ops(vcfg, V)
        # the pixels take no gradient: the patch embedding's backward is
        # its weight gradient alone
        ops += 3 * (t["linear"] + t["attention"]) + 2 * t["patch"]
        ops += 3 * C.projector_forward_ops(vcfg, geo["D"], V)
        ops += 2 * C.pool_forward_ops(vcfg, geo["D"], V)
        f = C.lm_forward_ops(geo, 2 * L, 2 * C.prefix_pairs(L, p), 2 * L)
        ops += 3 * (f["linear"] + f["attention"] + f["head"])
    return ops
