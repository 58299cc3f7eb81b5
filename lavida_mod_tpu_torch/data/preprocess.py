"""Training preprocessors, conversation -> (input_ids, labels): the port's
copy of lavida_mod_tpu/data/preprocess.py (host code, numpy only), held
equal to it by tests/test_torch_data.py (ids, labels and the numpy rng's
draws).

Parity with reference llava/train/train.py preprocess_llada (:761-885) and
preprocess_dream (:889-1020):

  - system message rendered but fully IGNORE'd;
  - ONE random human->assistant pair is selected from multi-turn data
    (`rng.choice(gpt_indices)`, train.py:820-823 -- a diffusion-specific
    choice: the bidirectional model would leak later turns);
  - the user turn is IGNORE'd; the assistant turn supervises everything
    after its header (the reference hard-codes the 6 header tokens,
    train.py:855-860 -- here computed from the rendered header);
  - optional FIM corruption of the assistant turn (train.py:838-845);
  - "<image>" occurrences become IMAGE_TOKEN_INDEX.

Works with any tokenizer exposing __call__(text).input_ids; rendering uses
the conversation templates (llama_3 for llada, chatml for dream).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from .conversation import DEFAULT_SYSTEM
from .infill import maybe_corrupt_assistant_turn
from .prompts import _encode

_ROLES = {"human": "user", "gpt": "assistant"}


def _norm_turn(turn: dict) -> tuple[str, str]:
    role = turn.get("role", turn.get("from"))
    content = turn.get("content", turn.get("value"))
    return _ROLES.get(role, role), content


def _render_llada(role: str, content: str) -> str:
    return f"<|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>"


def _render_dream(role: str, content: str) -> str:
    return f"<|im_start|>{role}\n{content}<|im_end|>\n"


_STYLES = {
    "llada": (_render_llada,
              "<|start_header_id|>assistant<|end_header_id|>\n\n"),
    "dream": (_render_dream, "<|im_start|>assistant\n"),
}


def _tokenize_with_images(tokenizer, text: str) -> list[int]:
    ids: list[int] = []
    chunks = text.split("<image>")
    for i, c in enumerate(chunks):
        if i > 0:
            ids.append(IMAGE_TOKEN_INDEX)
        if c:
            ids.extend(_encode(tokenizer, c))
    return ids


def preprocess_diffusion(
    source: Sequence[dict],
    tokenizer,
    style: str = "llada",
    has_image: bool = False,
    system_message: str = DEFAULT_SYSTEM,
    rng: Optional[np.random.Generator] = None,
    is_infill_model: bool = False,
) -> dict:
    """One conversation -> {"input_ids": [T], "labels": [T]} (numpy)."""
    rng = rng or np.random.default_rng()
    render, assistant_header = _STYLES[style]

    turns = [_norm_turn(t) for t in source]
    if turns and turns[0][0] != "user":
        turns = turns[1:]

    # random single-turn selection (train.py:820-823)
    human_idx = [i for i, (r, _) in enumerate(turns) if r == "user"]
    human_idx = [i for i in human_idx
                 if i + 1 < len(turns) and turns[i + 1][0] == "assistant"]
    assert human_idx, "no human->assistant pair in source"
    sel = int(rng.choice(human_idx))
    pair = turns[sel : sel + 2]

    input_ids: list[int] = []
    labels: list[int] = []

    sys_text = "<|startoftext|>" if style == "llada" else ""
    sys_text += render("system", system_message)
    sys_ids = _encode(tokenizer, sys_text)
    input_ids += sys_ids
    labels += [IGNORE_INDEX] * len(sys_ids)

    for idx, (role, content) in enumerate(pair):
        if idx == 0 and has_image and "<image>" not in content:
            content = "<image>\n" + content
        if is_infill_model and role == "assistant":
            content = maybe_corrupt_assistant_turn(content, rng)
        text = render(role, content)
        if role == "assistant":
            header_len = len(_encode(tokenizer, assistant_header))
            ids = _tokenize_with_images(tokenizer, text)
            input_ids += ids
            labels += [IGNORE_INDEX] * header_len + ids[header_len:]
        else:
            ids = _tokenize_with_images(tokenizer, text)
            input_ids += ids
            labels += [IGNORE_INDEX] * len(ids)

    assert len(input_ids) == len(labels)
    return {
        "input_ids": np.asarray(input_ids, np.int64),
        "labels": np.asarray(labels, np.int64),
    }


# ---------------------------------------------------------------------------
# AR-family preprocessors (reference train.py:418-1258)
#
# The reference ships one preprocessor per template family (llama_2, v1,
# mpt, qwen, gemma, llama3, plain), each re-deriving label masks from
# per-round string-split token-length arithmetic -- with a silent
# mask-everything fallback when the lengths drift ("tokenization
# mismatch ... (ignored)", train.py:1093-1096).  Re-design: render the
# conversation as (text, supervised) SEGMENTS and tokenize each segment
# independently, so the label mask is exact by construction for any
# tokenizer.  Supervision matches the reference intent: assistant
# responses (+ closing separator) train; system/user/role markers don't.
# ---------------------------------------------------------------------------


def _ar_segments(style: str, turns, system_message: str):
    """[(text, supervised)] for one conversation."""
    segs: list[tuple[str, bool]] = []

    def u(t):
        segs.append((t, False))

    def s(t):
        segs.append((t, True))

    if style in ("v1", "two"):  # preprocess_v1 (train.py:1021-1097)
        u(system_message + " ")
        for role, m in turns:
            if role == "user":
                u(f"USER: {m} ")
            else:
                u("ASSISTANT: ")
                s(f"{m}</s>")
    elif style in ("qwen", "chatml"):  # preprocess_qwen (:573-646)
        u(f"<|im_start|>system\n{system_message}<|im_end|>\n")
        for role, m in turns:
            if role == "user":
                u(f"<|im_start|>user\n{m}<|im_end|>\n")
            else:
                u("<|im_start|>assistant\n")
                s(f"{m}<|im_end|>\n")
    elif style == "mpt":  # preprocess_mpt (:1100-1178)
        u(f"<|im_start|>system\n{system_message}<|im_end|>")
        for role, m in turns:
            if role == "user":
                u(f"<|im_start|>user\n{m}<|im_end|>")
            else:
                u("<|im_start|>assistant\n")
                s(f"{m}<|im_end|>")
    elif style == "llama_2":  # preprocess_llama_2 (:418-491)
        first = True
        for role, m in turns:
            if role == "user":
                sys = (f"<<SYS>>\n{system_message}\n<</SYS>>\n\n"
                       if first and system_message else "")
                u(f"<s>[INST] {sys}{m} [/INST]")
                first = False
            else:
                s(f" {m} </s>")
    elif style == "gemma":  # preprocess_gemma (:494-570)
        for role, m in turns:
            if role == "user":
                u(f"<start_of_turn>user\n{m}<end_of_turn>\n")
            else:
                u("<start_of_turn>model\n")
                s(f"{m}<end_of_turn>\n")
    elif style == "llama_3":  # preprocess_llama3 (:649-758)
        u(f"<|start_header_id|>system<|end_header_id|>\n\n"
          f"{system_message}<|eot_id|>")
        for role, m in turns:
            if role == "user":
                u(f"<|start_header_id|>user<|end_header_id|>\n\n{m}<|eot_id|>")
            else:
                u("<|start_header_id|>assistant<|end_header_id|>\n\n")
                s(f"{m}<|eot_id|>")
    elif style == "plain":  # preprocess_plain (:1181-1200): image + caption
        assert len(turns) == 2
        u("<image>")
        s(turns[1][1] + "\n")
    else:
        raise NotImplementedError(f"AR preprocess style: {style}")
    return segs


_AR_STYLE_BY_TEMPLATE = {
    "v1": "v1", "vicuna_v1": "v1", "llava_v1": "v1",
    "qwen_1_5": "qwen", "qwen_2": "qwen",
    "mpt": "mpt", "chatml_direct": "mpt", "mistral_direct": "mpt",
    "mistral_orca": "mpt", "mistral_zephyr": "mpt",
    "llama_2": "llama_2", "llava_llama_2": "llama_2",
    "mistral_instruct": "llama_2", "llava_mistral_instruct": "llama_2",
    "llava_llama_3": "llama_3",
    "gemma_instruct": "gemma",
    "plain": "plain", "v0_plain": "plain",
}


def preprocess_ar(
    source: Sequence[dict],
    tokenizer,
    template: str = "v1",
    has_image: bool = False,
    system_message: str = DEFAULT_SYSTEM,
) -> dict:
    """One conversation -> {"input_ids", "labels"} for the AR baselines
    (llava_llama / llava_qwen / llava_mistral / llava_gemma families).
    `template` is a conversation-template name or a style key."""
    style = _AR_STYLE_BY_TEMPLATE.get(template, template)
    turns = [_norm_turn(t) for t in source]
    if turns and turns[0][0] != "user":
        turns = turns[1:]
    if has_image and turns and "<image>" not in turns[0][1]:
        turns[0] = (turns[0][0], "<image>\n" + turns[0][1])

    input_ids: list[int] = []
    labels: list[int] = []
    for text, supervised in _ar_segments(style, turns, system_message):
        ids = _tokenize_with_images(tokenizer, text)
        input_ids += ids
        labels += ids if supervised else [IGNORE_INDEX] * len(ids)
    return {
        "input_ids": np.asarray(input_ids, np.int64),
        "labels": np.asarray(labels, np.int64),
    }
