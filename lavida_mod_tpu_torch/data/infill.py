"""FIM (fill-in-the-middle) corruption utilities: the port's copy of
lavida_mod_tpu/data/infill.py.

Parity with reference llava/train/infill_utils.py: random insertion of
INFILL markers (optionally preceded by K FILL tokens) between words of an
assistant turn; stage-3 training teaches the model to complete around the
markers, and inference injects draft skeletons (generate.py:189-191).
"""

from __future__ import annotations

import numpy as np

INFILL_TOKEN = "<|reserved_token_1|>"   # id 126085
FILL_TOKEN = "<|reserved_token_2|>"     # id 126086


def count_num_words(s: str) -> int:
    return len(s.split())


def insert_infill_substrings(
    s: str, N: int = 4, K: int = 5, rng: np.random.Generator | None = None
) -> str:
    """Insert 1..N infill markers at random word boundaries; each marker is
    preceded by 0..K FILL tokens (infill_utils.py:8-31)."""
    rng = rng or np.random.default_rng()
    words = s.split()
    n = int(rng.integers(1, N + 1))
    if len(words) < 2 or n == 0:
        return s
    positions = set(
        rng.choice(
            np.arange(1, len(words)), size=min(n, len(words) - 1),
            replace=False,
        ).tolist()
    )
    out = []
    for i, w in enumerate(words):
        out.append(w)
        if i + 1 in positions:
            k = int(rng.integers(0, K + 1))
            out.append("".join([FILL_TOKEN] * k + [INFILL_TOKEN]) if k > 0
                       else INFILL_TOKEN)
    return " ".join(out)


def maybe_corrupt_assistant_turn(
    content: str,
    rng: np.random.Generator,
    prob: float = 0.8,
    min_words: int = 3,
) -> str:
    """The stage-3 policy (train.py:838-845): 80% of assistant turns longer
    than 3 words get 5-10 infill markers (10% of word count, clamped)."""
    n_words = count_num_words(content)
    if n_words > min_words and rng.random() < prob:
        n_infill = min(max(5, int(n_words * 0.1)), 10)
        return insert_infill_substrings(content, N=n_infill, K=5, rng=rng)
    return content
