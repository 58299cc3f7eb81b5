"""IFEval instruction-following verifiers (compact original
implementation of the reference's vendored checker library,
eval/lmms_eval/tasks/ifeval/{instructions.py,instructions_registry.py,
utils.py} — 3.5k LoC of checker classes re-expressed as ~25 pure
functions over the same instruction ids and kwargs).

Scoring protocol (utils.py:25-137): each doc carries instruction_id_list
+ per-instruction kwargs; STRICT grades the raw response, LOOSE retries
on variants (first/last line removed, asterisks stripped) and passes if
any variant passes.  Reported metrics: prompt-level (all instructions
followed) and instruction-level (per-instruction) accuracy, strict and
loose.

Divergence note: language:response_language uses langdetect upstream;
offline here, a letter-frequency heuristic distinguishes English vs
non-Latin scripts and defaults to True for Latin-script non-English
(documented, rarely hit in the English IFEval set).

The port's copy of lavida_mod_tpu/eval/ifeval.py (pure Python; that
package's eval/__init__.py imports JAX, so the port keeps its own).
tests/test_torch_eval.py holds it equal to the original.
"""

from __future__ import annotations

import json
import re
import string
from typing import Callable, Optional


def _rel(count: int, n: Optional[int], relation: Optional[str]) -> bool:
    if n is None:
        return count > 0
    if relation == "less than":
        return count < n
    return count >= n  # "at least" (the only other relation upstream)


def _words(text: str) -> list[str]:
    return re.findall(r"\w+", text)


# Abbreviation-aware sentence splitter, ported from the reference's
# instructions_util.py::split_into_sentences (itself the well-known
# public-domain regex splitter).  Upstream number_sentences actually
# counts via nltk punkt (instructions_util.py:1673-1678); punkt data is
# unavailable offline, and this splitter — which upstream also ships and
# uses at instructions.py:1013 — agrees with punkt on the IFEval corpus
# style (it handles Dr./Mr./Ph.D./acronyms/decimals, the cases the naive
# [.!?] split got wrong).
_ALPHABETS = "([A-Za-z])"
_PREFIXES = "(Mr|St|Mrs|Ms|Dr)[.]"
_SUFFIXES = "(Inc|Ltd|Jr|Sr|Co)"
_STARTERS = (r"(Mr|Mrs|Ms|Dr|Prof|Capt|Cpt|Lt|He\s|She\s|It\s|They\s|"
             r"Their\s|Our\s|We\s|But\s|However\s|That\s|This\s|Wherever)")
_ACRONYMS = "([A-Z][.][A-Z][.](?:[A-Z][.])?)"
_WEBSITES = "[.](com|net|org|io|gov|edu|me)"
_DIGITS = "([0-9])"
_MULTIPLE_DOTS = r"\.{2,}"


def _sentences(text: str) -> list[str]:
    text = " " + text + "  "
    text = text.replace("\n", " ")
    text = re.sub(_PREFIXES, "\\1<prd>", text)
    text = re.sub(_WEBSITES, "<prd>\\1", text)
    text = re.sub(_DIGITS + "[.]" + _DIGITS, "\\1<prd>\\2", text)
    text = re.sub(_MULTIPLE_DOTS,
                  lambda m: "<prd>" * len(m.group(0)) + "<stop>", text)
    if "Ph.D" in text:
        text = text.replace("Ph.D.", "Ph<prd>D<prd>")
    text = re.sub(r"\s" + _ALPHABETS + "[.] ", " \\1<prd> ", text)
    text = re.sub(_ACRONYMS + " " + _STARTERS, "\\1<stop> \\2", text)
    text = re.sub(_ALPHABETS + "[.]" + _ALPHABETS + "[.]" + _ALPHABETS
                  + "[.]", "\\1<prd>\\2<prd>\\3<prd>", text)
    text = re.sub(_ALPHABETS + "[.]" + _ALPHABETS + "[.]",
                  "\\1<prd>\\2<prd>", text)
    text = re.sub(" " + _SUFFIXES + "[.] " + _STARTERS, " \\1<stop> \\2",
                  text)
    text = re.sub(" " + _SUFFIXES + "[.]", " \\1<prd>", text)
    text = re.sub(" " + _ALPHABETS + "[.]", " \\1<prd>", text)
    if "”" in text:
        text = text.replace(".”", "”.")
    if '"' in text:
        text = text.replace('."', '".')
    if "!" in text:
        text = text.replace('!"', '"!')
    if "?" in text:
        text = text.replace('?"', '"?')
    text = text.replace(".", ".<stop>")
    text = text.replace("?", "?<stop>")
    text = text.replace("!", "!<stop>")
    text = text.replace("<prd>", ".")
    sentences = [s.strip() for s in text.split("<stop>")]
    if sentences and not sentences[-1]:
        sentences = sentences[:-1]
    return [s for s in sentences if s]


# --- keywords ---------------------------------------------------------------

def keywords_existence(t, keywords=None, **kw):
    # instructions.py:721 — the keyword string IS the pattern: raw
    # substring/regex search, no \b boundaries, no escaping
    return all(re.search(k, t, re.I) for k in (keywords or []))


def keywords_frequency(t, keyword=None, frequency=None, relation=None, **kw):
    # instructions.py:783 — raw re.findall(keyword, value, re.I)
    c = len(re.findall(keyword or "", t, re.I))
    return _rel(c, frequency, relation)


def keywords_forbidden(t, forbidden_words=None, **kw):
    # instructions.py:1055 — forbidden words DO get \b boundaries (and
    # no escaping), unlike existence/frequency
    return not any(re.search(r"\b" + k + r"\b", t, re.I)
                   for k in (forbidden_words or []))


def keywords_letter_frequency(t, letter=None, let_frequency=None,
                              let_relation=None, **kw):
    c = t.lower().count((letter or "").lower())
    return _rel(c, let_frequency, let_relation)


# --- language ---------------------------------------------------------------

def response_language(t, language=None, **kw):
    letters = [c for c in t if c.isalpha()]
    if not letters:
        return False
    latin = sum(c.isascii() for c in letters) / len(letters)
    if language == "en":
        return latin > 0.8
    # non-English requested: flag obviously-English (all-Latin) responses
    # only when a non-Latin script is expected; Latin-script languages
    # (es, fr, de...) pass — see module docstring
    nonlatin_langs = {"ar", "bn", "fa", "gu", "he", "hi", "ja", "kn", "ko",
                      "mr", "ne", "pa", "ru", "ta", "te", "th", "uk", "ur",
                      "zh", "bg", "el"}
    if language in nonlatin_langs:
        return latin < 0.5
    return True


# --- length constraints -----------------------------------------------------

def number_sentences(t, num_sentences=None, relation=None, **kw):
    return _rel(len(_sentences(t)), num_sentences, relation)


def number_paragraphs(t, num_paragraphs=None, **kw):
    # IFEval paragraphs are separated by "***" (instructions.py
    # ParagraphChecker)
    paras = [p for p in re.split(r"\s?\*\*\*\s?", t) if p.strip()]
    return len(paras) == num_paragraphs


def number_words(t, num_words=None, relation=None, **kw):
    return _rel(len(_words(t)), num_words, relation)


def nth_paragraph_first_word(t, num_paragraphs=None, nth_paragraph=None,
                             first_word=None, **kw):
    paras = [p.strip() for p in t.split("\n\n") if p.strip()]
    if len(paras) != num_paragraphs or not (1 <= (nth_paragraph or 0)
                                            <= len(paras)):
        return False
    first = (_words(paras[nth_paragraph - 1]) or [""])[0]
    return first.lower() == str(first_word).lower()


# --- detectable content -----------------------------------------------------

def number_placeholders(t, num_placeholders=None, **kw):
    return len(re.findall(r"\[.*?\]", t)) >= (num_placeholders or 1)


def postscript(t, postscript_marker=None, **kw):
    marker = postscript_marker or "P.S."
    if marker == "P.P.S":
        pat = r"\s*p\.\s?p\.\s?s.*$"
    elif marker == "P.S.":
        pat = r"\s*p\.\s?s\..*$"
    else:
        pat = r"\s*" + re.escape(marker.lower()) + r".*$"
    return bool(re.search(pat, t.lower(), re.M))


# --- detectable format ------------------------------------------------------

def number_bullets(t, num_bullets=None, **kw):
    bullets = re.findall(r"^\s*\*[^*].*$", t, re.M) \
        + re.findall(r"^\s*-.*$", t, re.M)
    return len(bullets) == num_bullets


def constrained_response(t, **kw):
    return any(a in t for a in
               ("My answer is yes.", "My answer is no.",
                "My answer is maybe."))


def number_highlights(t, num_highlights=None, **kw):
    single = [h for h in re.findall(r"\*[^\n*]*\*", t) if h.strip("* ")]
    double = [h for h in re.findall(r"\*\*[^\n*]*\*\*", t)
              if h.strip("* ")]
    return len(single) + len(double) >= (num_highlights or 1)


def multiple_sections(t, section_spliter=None, num_sections=None, **kw):
    spl = section_spliter or "Section"
    found = re.findall(rf"\s?{re.escape(spl)}\s?\d+", t)
    return len(found) == num_sections


def json_format(t, **kw):
    s = t.strip().removeprefix("```json").removeprefix("```") \
        .removesuffix("```").strip()
    try:
        json.loads(s)
        return True
    except ValueError:
        return False


def title(t, **kw):
    return any(x.strip("< >") for x in re.findall(r"<<[^\n]+>>", t))


# --- combination / startend / case / punctuation ----------------------------

def two_responses(t, **kw):
    parts = t.split("******")
    valid = [p.strip() for p in parts if p.strip()]
    return len(valid) == 2 and valid[0] != valid[1]


def repeat_prompt(t, prompt_to_repeat=None, **kw):
    return t.strip().lower().startswith(str(prompt_to_repeat).strip().lower())


def end_checker(t, end_phrase=None, **kw):
    return t.strip().strip('"').lower().endswith(
        str(end_phrase).strip().strip('"').lower())


def quotation(t, **kw):
    s = t.strip()
    return len(s) > 1 and s.startswith('"') and s.endswith('"')


def capital_word_frequency(t, capital_frequency=None,
                           capital_relation=None, **kw):
    caps = [w for w in _words(t) if w.isupper()]
    return _rel(len(caps), capital_frequency, capital_relation)


def english_capital(t, **kw):
    letters = [c for c in t if c.isalpha()]
    return bool(letters) and all(c.isupper() for c in letters)


def english_lowercase(t, **kw):
    letters = [c for c in t if c.isalpha()]
    return bool(letters) and all(c.islower() for c in letters)


def no_comma(t, **kw):
    return "," not in t


REGISTRY: dict[str, Callable[..., bool]] = {
    "keywords:existence": keywords_existence,
    "keywords:frequency": keywords_frequency,
    "keywords:forbidden_words": keywords_forbidden,
    "keywords:letter_frequency": keywords_letter_frequency,
    "language:response_language": response_language,
    "length_constraints:number_sentences": number_sentences,
    "length_constraints:number_paragraphs": number_paragraphs,
    "length_constraints:number_words": number_words,
    "length_constraints:nth_paragraph_first_word": nth_paragraph_first_word,
    "detectable_content:number_placeholders": number_placeholders,
    "detectable_content:postscript": postscript,
    "detectable_format:number_bullet_lists": number_bullets,
    "detectable_format:constrained_response": constrained_response,
    "detectable_format:number_highlighted_sections": number_highlights,
    "detectable_format:multiple_sections": multiple_sections,
    "detectable_format:json_format": json_format,
    "detectable_format:title": title,
    "combination:two_responses": two_responses,
    "combination:repeat_prompt": repeat_prompt,
    "startend:end_checker": end_checker,
    "startend:quotation": quotation,
    "change_case:capital_word_frequency": capital_word_frequency,
    "change_case:english_capital": english_capital,
    "change_case:english_lowercase": english_lowercase,
    "punctuation:no_comma": no_comma,
}


def _loose_variants(response: str) -> list[str]:
    """utils.py:58-110: retry with the first/last line removed (the model
    often wraps the answer) and with asterisks stripped."""
    r = response.strip()
    lines = r.split("\n")
    no_first = "\n".join(lines[1:]).strip()
    no_last = "\n".join(lines[:-1]).strip()
    no_both = "\n".join(lines[1:-1]).strip()
    base = [r, no_first, no_last, no_both]
    return base + [v.replace("*", "") for v in base]


def check_instruction(inst_id: str, response: str, kwargs: dict) -> bool:
    fn = REGISTRY.get(inst_id)
    if fn is None:
        return False
    kwargs = {k: v for k, v in (kwargs or {}).items() if v is not None}
    try:
        return bool(fn(response, **kwargs))
    except Exception:  # noqa: BLE001 — malformed kwargs grade as failed
        return False


def score_ifeval(doc: dict, response: str) -> dict:
    """Per-doc strict + loose rows (utils.py process_results)."""
    ids = doc.get("instruction_id_list", [])
    kwargs_list = doc.get("kwargs", [{}] * len(ids))
    strict = [check_instruction(i, response, k)
              for i, k in zip(ids, kwargs_list)]
    loose = [
        any(check_instruction(i, v, k) for v in _loose_variants(response))
        for i, k in zip(ids, kwargs_list)
    ]
    return {
        "prompt_level_strict_acc": float(all(strict)) if strict else 0.0,
        "inst_level_strict_acc": [float(s) for s in strict],
        "prompt_level_loose_acc": float(all(loose)) if loose else 0.0,
        "inst_level_loose_acc": [float(s) for s in loose],
    }


def aggregate_ifeval(rows: list[dict]) -> dict:
    def mean(xs):
        xs = list(xs)
        return sum(xs) / max(len(xs), 1)

    return {
        "prompt_level_strict_acc":
            mean(r["prompt_level_strict_acc"] for r in rows),
        "inst_level_strict_acc":
            mean(v for r in rows for v in r["inst_level_strict_acc"]),
        "prompt_level_loose_acc":
            mean(r["prompt_level_loose_acc"] for r in rows),
        "inst_level_loose_acc":
            mean(v for r in rows for v in r["inst_level_loose_acc"]),
    }
