"""Conversation templates (reference llava/conversation.py): the port's
copy of lavida_mod_tpu/data/conversation.py, every template of its
registry with the same renderers.

The reference's `llada` template renders through the LLaDA tokenizer's chat
template — LLaMA-3 header format (conversation.py:98-130, 464-475); `dream`
uses the same path with the Qwen/ChatML-flavored Dream tokenizer
(conversation.py:541-552); `plain` concatenates with "\n" (used by stage-1
pretraining).  Rendered here explicitly so the framework works without
network access to the tokenizer hubs; when a HF tokenizer with a
chat_template is supplied, it takes precedence (matching the reference's
apply_chat_template path).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_SYSTEM = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)


@dataclass
class Conversation:
    """An accumulating conversation; get_prompt() renders the full string."""

    name: str
    system: str = DEFAULT_SYSTEM
    roles: tuple[str, str] = ("user", "assistant")
    messages: list = field(default_factory=list)
    style: str = "llama_3"          # llama_3 | chatml | plain | single |
                                    # two | mpt | gemma | llama_2 | plain2
    sep: str = ""
    sep2: str = ""
    stop_token_ids: tuple[int, ...] = ()
    stop_str: Optional[str] = None
    tokenizer: object = None        # optional HF tokenizer with chat_template

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=list(self.messages))

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def _map_role(self, role: str) -> str:
        """Plain role names -> this template's role strings."""
        if role in ("user", "human", self.roles[0]):
            return self.roles[0]
        if role in ("assistant", "gpt", self.roles[1]):
            return self.roles[1]
        return role

    def get_prompt(self) -> str:
        if self.tokenizer is not None and getattr(
            self.tokenizer, "chat_template", None
        ):
            msgs = (
                [{"role": "system", "content": self.system}]
                if self.system else []
            ) + [
                {"role": r, "content": m} for r, m in self.messages if m
            ]
            return self.tokenizer.apply_chat_template(
                msgs, tokenize=False, add_generation_prompt=True
            )
        if self.style == "llama_3":
            return self._render_llama3()
        if self.style == "chatml":
            return self._render_chatml()
        if self.style == "plain":
            ret = self.system
            for _, m in self.messages:
                if m:
                    ret += m + "\n"
            return ret
        if self.style in _STYLE_RENDERERS:
            return _STYLE_RENDERERS[self.style](self)
        raise ValueError(self.style)

    def _render_llama3(self) -> str:
        ret = "<|startoftext|>"
        if self.system:
            ret += (
                "<|start_header_id|>system<|end_header_id|>\n\n"
                + self.system + "<|eot_id|>"
            )
        for role, m in self.messages:
            # None placeholders (reference-style "cue the assistant") are
            # skipped: the generation header below covers them, and the
            # tokenizer chat_template path filters them identically
            if m is not None:
                ret += (
                    f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                    + m + "<|eot_id|>"
                )
        ret += "<|start_header_id|>assistant<|end_header_id|>\n\n"
        return ret

    def _render_chatml(self) -> str:
        ret = ""
        if self.system:
            ret += f"<|im_start|>system\n{self.system}<|im_end|>\n"
        for role, m in self.messages:
            if m is not None:  # see _render_llama3 on None placeholders
                ret += f"<|im_start|>{role}\n{m}<|im_end|>\n"
        ret += "<|im_start|>assistant\n"
        return ret


# ---------------------------------------------------------------------------
# additional separator styles (reference conversation.py:65-212) — renderers
# keyed by style name; the template's `sep`/`sep2`/`roles` parameterize them.
# The generation cue matches the reference's append_message(role, None) +
# get_prompt() convention per style.
# ---------------------------------------------------------------------------


def _render_single(c: "Conversation") -> str:
    ret = c.system + c.sep
    for role, m in c.messages:
        if m:
            ret += c._map_role(role) + ": " + m + c.sep
    return ret + c.roles[1] + ":"


def _render_two(c: "Conversation") -> str:
    seps = (c.sep, c.sep2)
    ret = c.system + seps[0]
    for i, (role, m) in enumerate(c.messages):
        if m:
            ret += c._map_role(role) + ": " + m + seps[i % 2]
    return ret + c.roles[1] + ":"


def _render_mpt(c: "Conversation") -> str:
    # role strings carry their markers (e.g. "<|im_start|>user\n")
    ret = c.system + c.sep
    for role, m in c.messages:
        if m:
            ret += c._map_role(role) + m + c.sep
    return ret + c.roles[1]


def _render_gemma(c: "Conversation") -> str:
    ret = ""
    for role, m in c.messages:
        if m:
            ret += c._map_role(role) + m + c.sep
    return ret + c.roles[1]


def _render_llama2(c: "Conversation") -> str:
    def wrap_sys(msg):
        return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

    ret = ""
    msgs = [(r, m) for r, m in c.messages if m]
    for i, (role, m) in enumerate(msgs):
        if i == 0:
            m = wrap_sys(c.system) + m
        if i % 2 == 0:
            ret += c.sep + f"[INST] {m} [/INST]"
        else:
            ret += " " + m + " " + c.sep2
    return ret.lstrip(c.sep)


def _render_plain2(c: "Conversation") -> str:
    # pairwise PLAIN: messages joined by alternating sep/sep2 (stage-1
    # pretraining format: "<image>\ncaption\n")
    seps = (c.sep, c.sep2 or c.sep)
    ret = c.system
    for i, (_, m) in enumerate(c.messages):
        if m:
            ret += m + seps[i % 2]
    return ret


_STYLE_RENDERERS = {
    "single": _render_single,
    "two": _render_two,
    "mpt": _render_mpt,
    "gemma": _render_gemma,
    "llama_2": _render_llama2,
    "plain2": _render_plain2,
}

_VICUNA_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions."
)
_VICUNA_V1_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions."
)
_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant is able to understand the visual content "
    "that the user provides, and assist the user with a variety of tasks "
    "using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>."
)
_LLAMA2_SYSTEM = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe.  Your answers should not "
    "include any harmful, unethical, racist, sexist, toxic, dangerous, or "
    "illegal content. Please ensure that your responses are socially "
    "unbiased and positive in nature.\n\nIf a question does not make any "
    "sense, or is not factually coherent, explain why instead of "
    "answering something not correct. If you don't know the answer to a "
    "question, please don't share false information."
)


conv_templates: dict[str, Conversation] = {
    "llada": Conversation(
        name="llada", style="llama_3", stop_token_ids=(126348,),
        stop_str="<|eot_id|>",
    ),
    # Dream's chat template is ChatML (Qwen2 lineage — reference
    # conversation.py:541-552 routes through the Dream tokenizer whose
    # template emits <|im_start|> blocks; training preprocessing renders
    # the same format, data/preprocess.py).  The offline fallback must
    # match, otherwise prompts contain LLaMA-3 header tokens that don't
    # exist in Dream's vocab.
    "dream": Conversation(
        name="dream", style="chatml", stop_token_ids=(151643,),
        stop_str="<|im_end|>",
    ),
    "plain": Conversation(name="plain", system="", style="plain"),
    "qwen_1_5": Conversation(
        name="qwen_1_5", system="You are a helpful assistant.",
        style="chatml", stop_str="<|im_end|>",
    ),
}

# Full reference registry (conversation.py:657-684).  Seeded few-shot
# example messages in conv_vicuna_v0 are omitted (legacy LLaVA-v0 demo
# seeding, not a template property); everything else renders the
# reference separator semantics exactly.
_EXTRA_TEMPLATES = {
    "v0": Conversation(
        name="v0", system=_VICUNA_SYSTEM, roles=("Human", "Assistant"),
        style="single", sep="###",
    ),
    "v1": Conversation(
        name="v1", system=_VICUNA_V1_SYSTEM, roles=("USER", "ASSISTANT"),
        style="two", sep=" ", sep2="</s>", stop_str="</s>",
    ),
    "llama_2": Conversation(
        name="llama_2", system=_LLAMA2_SYSTEM, roles=("USER", "ASSISTANT"),
        style="llama_2", sep="<s>", sep2="</s>", stop_str="</s>",
    ),
    "llava_llama_2": Conversation(
        name="llava_llama_2", system=DEFAULT_SYSTEM,
        roles=("USER", "ASSISTANT"), style="llama_2",
        sep="<s>", sep2="</s>", stop_str="</s>",
    ),
    "llava_llama_2_simple": Conversation(
        name="llava_llama_2_simple",
        system="Answer the questions about the visual content that the "
               "user provides.",
        roles=("USER", "ASSISTANT"), style="llama_2",
        sep="<s>", sep2="</s>", stop_str="</s>",
    ),
    "llava_llama_2_mmtag": Conversation(
        name="llava_llama_2_mmtag",
        system="Answer the questions about the visual content that the "
               "user provides."
               "The visual content will be provided with the following "
               "format: <Image>visual content</Image>.",
        roles=("USER", "ASSISTANT"), style="llama_2",
        sep="<s>", sep2="</s>", stop_str="</s>",
    ),
    "llava_llama_3": Conversation(
        name="llava_llama_3", system=DEFAULT_SYSTEM, style="llama_3",
        stop_token_ids=(128009,), stop_str="<|eot_id|>",
    ),
    "mistral_instruct": Conversation(
        name="mistral_instruct", system="", roles=("USER", "ASSISTANT"),
        style="llama_2", sep="", sep2="</s>", stop_str="</s>",
    ),
    "mistral_orca": Conversation(
        name="mistral_orca",
        system="<|im_start|>system\nYou are MistralOrca, a large language "
               "model trained by Alignment Lab AI. Write out your "
               "reasoning step-by-step to be sure you get the right "
               "answers!",
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        style="mpt", sep="<|im_end|>",
    ),
    "mistral_zephyr": Conversation(
        name="mistral_zephyr",
        system="<|system|>\nYou are a helpful AI assistant.",
        roles=("<|user|>\n", "<|assistant|>\n"), style="mpt", sep="</s>",
    ),
    "mistral_direct": Conversation(
        name="mistral_direct",
        system="<|im_start|>system\nAnswer the questions.",
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        style="mpt", sep="<|im_end|>",
    ),
    "chatml_direct": Conversation(
        name="chatml_direct",
        system="<|im_start|>system\nAnswer the questions.",
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        style="mpt", sep="<|im_end|>",
    ),
    "mpt": Conversation(
        name="mpt",
        system="<|im_start|>system\nA conversation between a user and an "
               "LLM-based AI assistant. The assistant gives helpful and "
               "honest answers.",
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        style="mpt", sep="<|im_end|>",
    ),
    "llava_v0": Conversation(
        name="llava_v0", system=_VICUNA_SYSTEM,
        roles=("Human", "Assistant"), style="single", sep="###",
    ),
    "llava_v0_mmtag": Conversation(
        name="llava_v0_mmtag", system=_MMTAG_SYSTEM,
        roles=("Human", "Assistant"), style="single", sep="###",
    ),
    "llava_v1": Conversation(
        name="llava_v1", system=_VICUNA_SYSTEM,
        roles=("USER", "ASSISTANT"), style="two", sep=" ", sep2="</s>",
        stop_str="</s>",
    ),
    "llava_v1_mmtag": Conversation(
        name="llava_v1_mmtag", system=_MMTAG_SYSTEM,
        roles=("USER", "ASSISTANT"), style="two", sep=" ", sep2="</s>",
        stop_str="</s>",
    ),
    "gemma_instruct": Conversation(
        name="gemma_instruct", system="",
        roles=("<start_of_turn>user\n", "<start_of_turn>model\n"),
        style="gemma", sep="<end_of_turn>\n",
    ),
    "v0_plain": Conversation(
        name="v0_plain", system="", style="plain2", sep="\n",
    ),
}
conv_templates.update(_EXTRA_TEMPLATES)
conv_templates["default"] = conv_templates["v0"]
conv_templates["vicuna_v1"] = conv_templates["v1"]
conv_templates["qwen_2"] = conv_templates["qwen_1_5"]
conv_templates["llava_mistral_instruct"] = conv_templates["mistral_instruct"]


def get_conv_template(name: str) -> Conversation:
    """Fetch a template; unknown names fall back to `llada` (the reference
    has tokenizer/template fallback chains rather than hard failures,
    conversation.py:447-460)."""
    if name not in conv_templates:
        import warnings

        warnings.warn(f"unknown conversation template {name!r}; "
                      "falling back to 'llada'")
        name = "llada"
    return conv_templates[name].copy()
