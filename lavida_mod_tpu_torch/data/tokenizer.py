"""Offline tokenizer, checkpoint directory in, token ids out: the port's
copy of lavida_mod_tpu/data/tokenizer.py.

  load_tokenizer(ckpt_dir)
    1. `tokenizer.json` through the `tokenizers` runtime when it is
       importable (exact HF semantics, still offline);
    2. otherwise `ByteLevelBPE`, a pure-Python byte-level BPE built from
       `vocab.json` + `merges.txt` or from `tokenizer.json`'s model: the
       GPT-2 byte <-> unicode table, regex pre-tokenization (the
       Qwen/Dream pattern by default), ranked merges and the split on
       added tokens (tokenization_dream.py semantics).
  load_hf_or_offline(ckpt_dir): transformers' AutoTokenizer when it can
    build one from the directory, else `load_tokenizer`.

Both return objects with the HF surface the port uses:
`__call__(text).input_ids`, `encode`, `decode`, `chat_template` /
`apply_chat_template` (rendered with jinja2, imported there).

Differences from the JAX package's module:
  - the pre-tokenization runs on the `regex` package when it imports, as
    the JAX package's does; without it, on the standard library's `re`
    (`compile_pattern`): `\\p{L}` and `\\p{N}` become explicit classes of
    the code points whose Unicode category is a letter or a number (from
    `unicodedata`, built once per process), and `\\s` / `\\S` the Unicode
    White_Space set, as `regex` and the `tokenizers` runtime read them
    (`re`'s own `\\s` also takes U+001C..U+001F).  On that fallback the
    characters assigned after the interpreter's Unicode version are not
    letters (Python 3.12's `unicodedata` is Unicode 15.0);
  - the merge loop is the pure-Python one only; the C++ merge engine of
    the JAX package (csrc/bpe.cpp through data/native.py) is not ported.
`regex`, `tokenizers`, `transformers` and `jinja2` are imported only
inside the functions that use them.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Optional, Sequence

# Qwen/Dream pre-tokenization pattern (tokenization_dream.py:41)
PRETOKENIZE_REGEX = (
    r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"""
    r""" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
)
# Unicode White_Space, the `\s` of `regex` and of the tokenizers runtime
_WHITE_SPACE = (r"\t\n\x0b\x0c\r\x20\x85\xa0\u1680\u2000-\u200a\u2028"
                r"\u2029\u202f\u205f\u3000")


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table
    (tokenization_dream.py:44-66 semantics)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _ranges(cps: list[int]) -> str:
    out, i = [], 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        lo, hi = (f"\\U{c:08x}" for c in (cps[i], cps[j]))
        out.append(lo if i == j else f"{lo}-{hi}")
        i = j + 1
    return "".join(out)


@functools.lru_cache()
def _category_classes() -> dict[str, str]:
    """{"L": ranges of the letters, "N": of the numbers}, as the inside
    of a character class."""
    cats: dict[str, list[int]] = {"L": [], "N": []}
    for cp in range(sys.maxunicode + 1):
        c = unicodedata.category(chr(cp))[0]
        if c in cats:
            cats[c].append(cp)
    return {k: _ranges(v) for k, v in cats.items()}


def pretokenizer(pattern: str):
    """`pattern` compiled by the `regex` package when it imports (its own
    Unicode tables), else by `compile_pattern`."""
    try:
        import regex
    except ImportError:
        return compile_pattern(pattern)
    return regex.compile(pattern)


@functools.lru_cache()
def compile_pattern(pattern: str) -> re.Pattern:
    """`pattern` in the `regex` package's syntax, with `\\p{L}`, `\\p{N}`,
    `\\s` and `\\S` in it, compiled by the standard library's `re`."""
    classes = _category_classes()
    out, i, class_start = [], 0, None
    while i < len(pattern):
        in_class = class_start is not None
        c = pattern[i]
        if c == "\\":
            esc = pattern[i:i + 2]
            if pattern.startswith(("\\p{L}", "\\p{N}"), i):
                body = classes[pattern[i + 3]]
                out.append(body if in_class else f"[{body}]")
                i += 5
                continue
            if esc == "\\s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
            elif esc == "\\S":
                if in_class:
                    raise ValueError("\\S inside a character class")
                out.append(f"[^{_WHITE_SPACE}]")
            elif esc.startswith("\\p"):
                raise ValueError(f"unsupported property in {pattern!r}")
            else:
                out.append(esc)
            i += 2
            continue
        if c == "[" and not in_class:
            class_start = i + 1 + (pattern[i + 1:i + 2] == "^")
        elif c == "]" and in_class and i > class_start:
            class_start = None      # a "]" first in a class is literal
        out.append(c)
        i += 1
    return re.compile("".join(out))


class _Encoded:
    """The result of calling a tokenizer: `.input_ids`."""

    def __init__(self, input_ids: list[int]):
        self.input_ids = input_ids


def _render_chat(chat_template: Optional[str], messages,
                 add_generation_prompt: bool) -> str:
    if not chat_template:
        raise ValueError("no chat template in tokenizer_config.json")
    import jinja2

    env = jinja2.Environment()
    env.filters.setdefault("tojson", lambda v, **kw: json.dumps(v, **kw))
    return env.from_string(chat_template).render(
        messages=messages, add_generation_prompt=add_generation_prompt,
        bos_token="", eos_token="")


class ByteLevelBPE:
    """Pure-Python byte-level BPE with HF-compatible results."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: Sequence[tuple[str, str]],
        special_tokens: Optional[dict[str, int]] = None,
        pattern: str = PRETOKENIZE_REGEX,
        chat_template: Optional[str] = None,
        bos_token_id: Optional[int] = None,
        eos_token_id: Optional[int] = None,
    ):
        self.vocab = dict(vocab)
        self.id2tok = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.special = dict(special_tokens or {})
        for t, i in self.special.items():
            self.vocab.setdefault(t, i)
            self.id2tok.setdefault(i, t)
        self.pat = pretokenizer(pattern)
        self.b2u = bytes_to_unicode()
        self.u2b = {u: b for b, u in self.b2u.items()}
        self.chat_template = chat_template
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self._special_ids = set(self.special.values())
        self._special_pat = None
        if self.special:
            self._special_pat = re.compile("(" + "|".join(
                re.escape(t)
                for t in sorted(self.special, key=len, reverse=True)) + ")")
        self._bpe_cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            out = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        if len(self._bpe_cache) < 65536:
            self._bpe_cache[token] = word
        return word

    def _encode_ordinary(self, text: str) -> list[int]:
        text = unicodedata.normalize("NFC", text)
        ids = []
        for tok in self.pat.findall(text):
            mapped = "".join(self.b2u[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[piece] for piece in self._bpe(mapped))
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        if self._special_pat is None:
            ids = self._encode_ordinary(text)
        else:
            ids = []
            for chunk in self._special_pat.split(text):
                if chunk in self.special:
                    ids.append(self.special[chunk])
                elif chunk:
                    ids.extend(self._encode_ordinary(chunk))
        if add_special_tokens and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        return _Encoded(self.encode(text, add_special_tokens))

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            tok = self.id2tok.get(i)
            if tok is None:
                continue
            if i in self._special_ids or tok in self.special:
                if not skip_special_tokens:
                    pieces.append(tok)
                continue
            pieces.append(tok)
        data = bytes(self.u2b[c] for c in "".join(pieces) if c in self.u2b)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages, tokenize: bool = False,
                            add_generation_prompt: bool = True):
        out = _render_chat(self.chat_template, messages,
                           add_generation_prompt)
        return self.encode(out) if tokenize else out


def _read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _tokenizer_config(ckpt_dir: str) -> dict:
    path = os.path.join(ckpt_dir, "tokenizer_config.json")
    return _read_json(path) if os.path.exists(path) else {}


def _ids_from_config(tcfg: dict, vocab: dict) -> tuple:
    def tok_id(key):
        t = tcfg.get(key)
        if isinstance(t, dict):
            t = t.get("content")
        return vocab.get(t) if isinstance(t, str) else None

    return tok_id("bos_token"), tok_id("eos_token")


def load_pure_bpe(ckpt_dir: str) -> ByteLevelBPE:
    """The pure-Python tokenizer from `vocab.json` + `merges.txt` (added
    tokens from `tokenizer.json` when there is one) or `tokenizer.json`
    alone."""
    vj = os.path.join(ckpt_dir, "vocab.json")
    mf = os.path.join(ckpt_dir, "merges.txt")
    tj = os.path.join(ckpt_dir, "tokenizer.json")
    special: dict[str, int] = {}
    if os.path.exists(vj) and os.path.exists(mf):
        vocab = _read_json(vj)
        merges = []
        with open(mf, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        if os.path.exists(tj):
            for at in _read_json(tj).get("added_tokens", []):
                special[at["content"]] = at["id"]
    elif os.path.exists(tj):
        data = _read_json(tj)
        model = data.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported tokenizer model "
                             f"{model.get('type')!r}")
        vocab = model["vocab"]
        merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" "))
                  for m in model["merges"]]
        for at in data.get("added_tokens", []):
            special[at["content"]] = at["id"]
    else:
        raise FileNotFoundError(
            f"no tokenizer files (tokenizer.json / vocab.json+merges.txt) "
            f"in {ckpt_dir}")
    tcfg = _tokenizer_config(ckpt_dir)
    bos, eos = _ids_from_config(tcfg, {**vocab, **special})
    return ByteLevelBPE(vocab, merges, special,
                        chat_template=tcfg.get("chat_template"),
                        bos_token_id=bos, eos_token_id=eos)


class _FastWrapper:
    """A `tokenizers`-runtime tokenizer behind the same surface."""

    def __init__(self, tok, chat_template, bos_token_id, eos_token_id):
        self._tok = tok
        self.chat_template = chat_template
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id

    def encode(self, text, add_special_tokens: bool = False):
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_special_tokens and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text, add_special_tokens: bool = True):
        return _Encoded(self.encode(text, add_special_tokens))

    def decode(self, ids, skip_special_tokens: bool = True):
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=skip_special_tokens)

    def apply_chat_template(self, messages, tokenize: bool = False,
                            add_generation_prompt: bool = True):
        out = _render_chat(self.chat_template, messages,
                           add_generation_prompt)
        return self.encode(out) if tokenize else out


def load_tokenizer(ckpt_dir: str, prefer_pure: bool = False):
    """Checkpoint dir -> tokenizer: the `tokenizers` runtime when it is
    importable and the directory has tokenizer.json, else (or with
    prefer_pure) `load_pure_bpe`."""
    tj = os.path.join(ckpt_dir, "tokenizer.json")
    if not prefer_pure and os.path.exists(tj):
        try:
            from tokenizers import Tokenizer
        except ImportError:
            return load_pure_bpe(ckpt_dir)
        tok = Tokenizer.from_file(tj)
        tcfg = _tokenizer_config(ckpt_dir)
        bos, eos = _ids_from_config(tcfg, tok.get_vocab())
        return _FastWrapper(tok, tcfg.get("chat_template"), bos, eos)
    return load_pure_bpe(ckpt_dir)


def load_hf_or_offline(ckpt_dir: str):
    """transformers' AutoTokenizer when it can build one from the local
    directory (vendored tokenizer classes, sentencepiece files, ...),
    else the offline `load_tokenizer`."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(
            ckpt_dir, local_files_only=True, trust_remote_code=True)
    except Exception:  # no transformers, or no tokenizer it can build
        return load_tokenizer(ckpt_dir)
