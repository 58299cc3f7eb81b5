"""Transfer-count schedules for masked-diffusion decoding: a numpy copy of
lavida_mod_tpu/ops/schedules.py.

A copy and not an import: the JAX file is numpy-only, but importing it runs
`lavida_mod_tpu/ops/__init__.py`, which imports jax.  tests/test_torch_ops.py
holds the two equal over several (counts, steps, schedule) cases.

Host-side on purpose: the per-step counts depend only on each block's
initial mask count, so the whole `[batch, steps]` table is precomputed once
and the denoise loop never syncs with the host.  Semantics replicate the
reference generate.py:22-114 (see the JAX module for line-level notes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.special import erf


def cosine_curve(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return 1.0 - 0.5 * (1.0 + np.cos(np.pi * t))


def logit_normal_cdf_curve(t: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        logit = np.log(t / (1.0 - t))
    return 0.5 * (1.0 + erf(logit / np.sqrt(2.0)))


def shift_curve(t: np.ndarray, shift: float) -> np.ndarray:
    return shift * t / (1.0 + (shift - 1.0) * t)


def num_transfer_tokens(mask_counts: np.ndarray, steps: int) -> np.ndarray:
    """Uniform split of each row's mask count over `steps` steps; the first
    `remainder` steps get one extra.  Returns [batch, steps] int64."""
    mask_counts = np.asarray(mask_counts, dtype=np.int64).reshape(-1)
    base = mask_counts // steps
    rem = mask_counts % steps
    out = np.tile(base[:, None], (1, steps))
    return out + (np.arange(steps)[None, :] < rem[:, None]).astype(np.int64)


def num_transfer_tokens_scheduled(
    mask_counts: np.ndarray,
    steps: int,
    schedule: Optional[str] = None,
    shift: float = 3.0,
) -> np.ndarray:
    """Scheduled per-step counts, [batch, min(steps, mask_counts[0])] int64,
    time-reversed so index 0 is the first denoise step; each row sums to
    its mask count with every entry >= 1."""
    mask_counts = np.asarray(mask_counts, dtype=np.int64).reshape(-1)
    if schedule is None:
        return num_transfer_tokens(mask_counts, steps)

    steps = int(min(steps, mask_counts[0]))
    t = np.linspace(0.0, 1.0, steps + 1)
    if schedule == "logit_normal":
        sig = logit_normal_cdf_curve(t)
    elif schedule == "shift":
        sig = shift_curve(t, shift)
    elif schedule == "cosine":
        sig = cosine_curve(t)
    elif schedule == "linear":
        sig = t
    else:
        raise ValueError(f"unknown schedule: {schedule}")

    out = np.zeros((mask_counts.shape[0], steps), dtype=np.int64)
    for i, n in enumerate(mask_counts):
        if n < steps:
            # fewer masked tokens than steps: one token per step for the
            # first n steps (post-flip), 0 for the rest
            out[i] = np.array([0] * (steps - int(n)) + [1] * int(n), np.int64)
            continue
        cum = (sig * n).astype(np.int64)
        cum[0], cum[-1] = 0, n
        d = np.clip(cum[1:] - cum[:-1], 1, None)
        delta = int(d.sum() - n)
        if delta < 0:
            raise AssertionError(f"schedule over-committed: {d}")
        j = 0
        while delta > 0:
            j = j % len(d)
            if d[j] == 1:
                j += 1
                continue
            d[j] -= 1
            delta -= 1
            j += 1
        out[i] = d
    return out[:, ::-1].copy()


def resolve_steps(
    max_new_tokens: int,
    block_length: int,
    steps: Optional[int] = None,
    step_per_block: Optional[int] = None,
    step_ratio: Optional[float] = None,
) -> tuple[int, int]:
    """(num_blocks, steps_per_block) with the reference's precedence
    (generate.py:146-208)."""
    if max_new_tokens % block_length:
        raise ValueError(f"max_new_tokens {max_new_tokens} is not a multiple "
                         f"of block_length {block_length}")
    num_blocks = max_new_tokens // block_length
    steps = max_new_tokens if steps is None else steps
    if steps % num_blocks and step_per_block is None:
        raise ValueError(f"{steps} steps do not divide over {num_blocks} "
                         f"blocks")
    steps = steps // num_blocks
    if step_per_block:
        if step_ratio is not None:
            raise ValueError("pass step_ratio or step_per_block, not both")
        steps = min(step_per_block, block_length)
    if step_ratio:
        steps = int(steps * step_ratio)
    return num_blocks, steps
