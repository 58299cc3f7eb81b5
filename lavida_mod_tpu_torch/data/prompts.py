"""Prompt tokenization with image placeholders: the port's copy of
lavida_mod_tpu/data/prompts.py.

`tokenizer_image_token` splices IMAGE_TOKEN_INDEX (-200) at each "<image>"
occurrence (reference llava/mm_utils.py:473-492), BOS-dedup included.
Works with any HF-style tokenizer (callable returning .input_ids or a
plain encode method).
"""

from __future__ import annotations


import numpy as np

from ..constants import IMAGE_TOKEN_INDEX


def _encode(tokenizer, text: str) -> list[int]:
    out = tokenizer(text)
    ids = out.input_ids if hasattr(out, "input_ids") else out["input_ids"]
    return list(ids)


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> np.ndarray:
    chunks = [_encode(tokenizer, c) for c in prompt.split("<image>")]
    bos = getattr(tokenizer, "bos_token_id", None)

    ids: list[int] = []
    offset = 0
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: list[list[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        ids.extend(x[offset:])
    return np.asarray(ids, np.int64)
