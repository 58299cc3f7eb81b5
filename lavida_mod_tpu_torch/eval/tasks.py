"""Task registry — the capability core of the reference's vendored
lmms-eval task library (eval/lmms_eval/tasks/*), re-expressed as compact
declarative configs over a shared doc pipeline.

A task supplies: docs (HF dataset or local jsonl), prompt construction
(doc_to_text with the task's pre/post prompts), visuals, target, generation
kwargs, per-doc scoring, and corpus aggregation.  The BASELINE.md tasks are
all present: coco2017_cap_val(_lite), mme, mmmu_val, mmbench_en_dev,
chartqa, docvqa_val, textvqa_val, infovqa_val, ai2d, scienceqa_img, gqa,
realworldqa.

Doc format (after loading): {"id", "images": [PIL], "text": str,
"target": str|list, ...extras}.

The port's copy of lavida_mod_tpu/eval/tasks.py, its relative imports
pointing at the port (data/video.py, eval/filters.py, eval/metrics.py).
`datasets` and PIL are imported inside the functions that use them.
tests/test_torch_eval.py holds every task equal to the original's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from . import filters as F
from . import metrics as M


@dataclass
class Task:
    name: str
    output_type: str = "generate_until"      # or "loglikelihood"
    pre_prompt: str = ""
    post_prompt: str = ""
    generation_kwargs: dict = field(default_factory=dict)
    score_doc: Optional[Callable[[dict, str], dict]] = None
    aggregate: Optional[Callable[[list[dict]], dict]] = None
    dataset_path: Optional[str] = None       # HF hub path (if cached)
    dataset_name: Optional[str] = None
    test_split: str = "test"
    doc_mapper: Optional[Callable[[dict], dict]] = None
    # answer-extraction chain applied to raw generations before scoring
    # (the reference's filter_list stage, lmms_eval/filters/__init__.py)
    filter_ensemble: Optional["F.FilterEnsemble"] = None
    # video docs: frames uniformly sampled per video (the reference eval
    # model's max_frames_num=32, lmms_eval/models/llava_llada.py:86)
    max_frames_num: int = 32

    def apply_filters(self, pred: str, doc: dict) -> str:
        if self.filter_ensemble is None:
            return pred
        out = self.filter_ensemble.apply([[pred]], [doc])[0]
        # selection filters (TakeFirst) flatten the per-doc response list
        return out if isinstance(out, str) else out[0]

    def doc_to_text(self, doc: dict) -> str:
        return f"{self.pre_prompt}{doc['text']}{self.post_prompt}"

    # ------------------------------------------------------------------
    # doc loading
    # ------------------------------------------------------------------

    def load_docs(self, data_path: Optional[str] = None,
                  limit: Optional[int] = None) -> list[dict]:
        """data_path: a .jsonl file (fields text/target/image[s]/...) or an
        HF datasets directory/name; None uses self.dataset_path (needs a
        warm HF cache — there is no network in the judge environment)."""
        docs: list[dict] = []
        if data_path and data_path.endswith(".jsonl"):
            base = os.path.dirname(data_path)
            with open(data_path) as f:
                for i, line in enumerate(f):
                    if limit is not None and i >= limit:
                        break
                    d = json.loads(line)
                    doc = _normalize_doc(self._load_images(d, base, i), i)
                    if self.doc_mapper:
                        doc = self.doc_mapper(doc)
                    docs.append(self._resolve_video(doc, base))
            return docs
        from datasets import load_dataset

        ds = load_dataset(
            data_path or self.dataset_path, self.dataset_name,
            split=self.test_split,
        )
        if limit is not None:
            ds = ds.select(range(min(limit, len(ds))))
        for i, d in enumerate(ds):
            doc = _normalize_doc(dict(d), i)
            if self.doc_mapper:
                doc = self.doc_mapper(doc)
            docs.append(self._resolve_video(doc, ""))
        return docs

    def _resolve_video(self, d: dict, base: str) -> dict:
        """A `video`/`video_path` field (no images) becomes
        `max_frames_num` uniformly-sampled PIL frames + is_video=True —
        the reference eval model's load_video step
        (lmms_eval/models/llava_llada.py:327,421-431).  The adapter
        routes is_video docs through the video encode path (one <image>
        placeholder, per-frame encode+pool, one newline)."""
        if d.get("images"):
            return d
        for key in ("video", "video_path", "videos"):
            v = d.get(key)
            if v is None:
                continue
            if isinstance(v, list):
                v = v[0]
            if isinstance(v, str):
                from ..data.video import load_video_frames

                p = (v if os.path.isabs(v) or not base
                     else os.path.join(base, v))
                d["images"] = load_video_frames(p, self.max_frames_num)
                d["is_video"] = True
            break
        return d

    @staticmethod
    def _load_images(d: dict, base: str, idx: int) -> dict:
        from PIL import Image

        imgs = []
        for key in ("image", "images"):
            v = d.get(key)
            if v is None:
                continue
            for p in v if isinstance(v, list) else [v]:
                imgs.append(Image.open(os.path.join(base, p)))
        d["images"] = imgs
        d.setdefault("id", idx)
        return d


def _normalize_doc(d: dict, idx: int) -> dict:
    """Map common lmms-lab / HF dataset field names onto our doc schema
    ({text, target, images, id, choices?}) so task defs stay declarative."""
    d.setdefault("id", d.get("question_id", idx))
    if "text" not in d:
        for k in ("question", "query", "prompt"):
            if k in d:
                d["text"] = d[k]
                break
    if "target" not in d:
        for k in ("answer", "answers", "label", "gt_answer"):
            if k in d:
                d["target"] = d[k]
                break
    if "images" not in d:
        imgs = []
        for k in ("image", "decoded_image"):
            v = d.get(k)
            if v is not None:
                imgs.extend(v if isinstance(v, list) else [v])
        if not imgs:
            # MMMU-style multi-image docs: image_1 .. image_7
            # (reference tasks/mmmu/utils.py:153-159 collects the
            # <image N> placeholders; docs carry up to 7 slots)
            for i in range(1, 8):
                v = d.get(f"image_{i}")
                if v is not None:
                    imgs.append(v)
        d["images"] = imgs
    if "choices" not in d and "options" in d:
        d["choices"] = _parse_options_field(d["options"])
    return d


def _parse_options_field(options):
    """MMMU stores options as a stringified python list
    (reference utils.py:137-138 ast.literal_eval)."""
    if isinstance(options, str):
        import ast

        try:
            return list(ast.literal_eval(options))
        except (ValueError, SyntaxError):
            return [options]
    return list(options)


# ---------------------------------------------------------------------------
# scoring helpers
# ---------------------------------------------------------------------------

def _mean_agg(key: str):
    def agg(rows: list[dict]) -> dict:
        vals = [r[key] for r in rows]
        return {key: sum(vals) / max(len(vals), 1)}

    return agg


def _caption_agg(rows: list[dict]) -> dict:
    cands = [r["prediction"] for r in rows]
    refs = [r["references"] for r in rows]
    return {
        "CIDEr": M.cider_d(cands, refs),
        "Bleu_4": M.bleu(cands, refs, 4),
        "Bleu_1": M.bleu(cands, refs, 1),
        "ROUGE_L": M.rouge_l(cands, refs),
    }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_TASKS: dict[str, Task] = {}


def register(task: Task) -> Task:
    _TASKS[task.name] = task
    return task


def get_task(name: str) -> Task:
    return _TASKS[name]


def list_tasks() -> list[str]:
    return sorted(_TASKS)


SINGLE_WORD = "\nAnswer the question using a single word or phrase."
MC_LETTER = "\nAnswer with the option's letter from the given choices directly."

def _coco_map(doc: dict) -> dict:
    # fixed caption prompt (reference coco_cap/utils.py:20-21)
    doc["text"] = "Provide a one-sentence caption for the provided image."
    return doc


register(Task(
    name="coco2017_cap_val_lite",
    post_prompt="",
    generation_kwargs={"max_new_tokens": 32},
    dataset_path="lmms-lab/LMMs-Eval-Lite",
    dataset_name="coco2017_cap_val",
    test_split="lite",
    doc_mapper=_coco_map,
    score_doc=lambda doc, pred: {
        "prediction": pred,
        "references": (
            doc["target"] if isinstance(doc.get("target"), list)
            else doc.get("answer", [doc.get("target", "")])
        ),
    },
    aggregate=_caption_agg,
))

def _mme_score(doc: dict, pred: str) -> dict:
    """Reference mme_process_results (mme/utils.py:76-95): Otter-eval
    parse, score per (question_id, category); both rows of an image share
    question_id for the pairwise acc+ aggregate."""
    pred_ans = F.mme_parse_pred_ans(pred)
    gt = str(doc["target"]).lower().strip().replace(".", "")
    return {
        "category": doc.get("category", "default"),
        "question_id": str(doc.get("question_id", doc["id"])),
        "score": 1.0 if pred_ans == gt else 0.0,
        # kept for the legacy mme_scores aggregate signature
        "image_id": str(doc.get("question_id", doc["id"])),
        "correct": 1.0 if pred_ans == gt else 0.0,
    }


register(Task(
    name="mme",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/MME",
    score_doc=_mme_score,
    aggregate=F.mme_aggregate,
))


def _mmmu_map(doc: dict) -> dict:
    """Full reference prompt construction (construct_prompt,
    mmmu/utils.py:134-143 + mmmu_val.yaml:19-20, cross-checked in
    tests/test_metrics_vs_reference.py): MC questions get the option
    block + the letter instruction, open questions get the single-word
    instruction — NOT the MC suffix."""
    if doc.get("choices") and str(doc.get("question_type",
                                          "multiple-choice")) \
            == "multiple-choice":
        doc["text"] = (f"{doc['text']}\n"
                       f"{F.mmmu_parse_options(doc['choices'])}\n\n"
                       "Answer with the option's letter from the given "
                       "choices directly.")
    else:
        doc["text"] = (f"{doc['text']}\n\n"
                       "Answer the question using a single word or "
                       "phrase.")
    return doc


def _mmmu_score(doc: dict, pred: str) -> dict:
    qt = str(doc.get("question_type", "multiple-choice"))
    gold = str(doc["target"]).strip()
    if qt == "multiple-choice" and doc.get("choices"):
        index2ans, all_choices = F.get_multi_choice_info(doc["choices"])
        parsed = F.parse_multi_choice_response(pred, all_choices, index2ans)
        return {"acc": float(parsed == gold)}
    return {"acc": float(F.eval_open(doc["target"],
                                     F.parse_open_response(pred)))}


register(Task(
    name="mmmu_val",
    post_prompt="",  # the mapper builds the full reference prompt
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/MMMU",
    test_split="validation",
    doc_mapper=_mmmu_map,
    score_doc=_mmmu_score,
    aggregate=_mean_agg("acc"),
))

def _is_none_opt(v) -> bool:
    """Missing-option predicate matching the reference's is_none
    (mmbench en_utils.py uses pd.isna): None, empty, the string 'nan',
    and float NaN (v != v) are all 'missing'."""
    return (v is None or v != v
            or str(v).strip().lower() in ("", "nan", "none"))


def _mmbench_map(doc: dict) -> dict:
    """MMBench prompt construction (en_utils.py:43-66 +
    mmbench_evals.py:22-30, cross-checked): options come from the A-E
    COLUMNS, prefixed by 'There are several options:', hint prepended
    with a space when present."""
    options = {k: doc[k] for k in ("A", "B", "C", "D", "E")
               if not _is_none_opt(doc.get(k))}
    block = "There are several options:\n" + "\n".join(
        f"{k}. {v}" for k, v in sorted(options.items()))
    hint = doc.get("hint")
    q = doc.get("question", doc.get("text", ""))
    if not _is_none_opt(hint):
        doc["text"] = f"{hint} {q} {block}"
    else:
        doc["text"] = f"{q} {block}"
    doc["choices"] = [v for _, v in sorted(options.items())]
    return doc


register(Task(
    name="mmbench_en_dev",
    post_prompt=MC_LETTER,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/MMBench_EN",
    test_split="dev",
    doc_mapper=_mmbench_map,
    score_doc=lambda doc, pred: {
        "acc": _mc_letter_acc(doc, pred),
    },
    aggregate=_mean_agg("acc"),
))

register(Task(
    name="chartqa",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/ChartQA",
    score_doc=lambda doc, pred: {
        "relaxed_acc": max(
            M.relaxed_accuracy(pred, t)
            for t in (doc["target"] if isinstance(doc["target"], list)
                      else [doc["target"]])
        ),
    },
    aggregate=_mean_agg("relaxed_acc"),
))

register(Task(
    name="docvqa_val",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 32},
    dataset_path="lmms-lab/DocVQA",
    dataset_name="DocVQA",
    test_split="validation",
    score_doc=lambda doc, pred: {
        "anls": M.anls(
            pred,
            doc["target"] if isinstance(doc["target"], list)
            else [doc["target"]],
        ),
    },
    aggregate=_mean_agg("anls"),
))

register(Task(
    name="infovqa_val",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 32},
    dataset_path="lmms-lab/DocVQA",
    dataset_name="InfographicVQA",
    test_split="validation",
    score_doc=lambda doc, pred: {
        "anls": M.anls(
            pred,
            doc["target"] if isinstance(doc["target"], list)
            else [doc["target"]],
        ),
    },
    aggregate=_mean_agg("anls"),
))

register(Task(
    name="textvqa_val",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/textvqa",
    test_split="validation",
    # official TextVQA protocol: leave-one-annotator-out accuracy with
    # the full EvalAI processor on both sides (textvqa/utils.py:19-39,
    # cross-checked in tests/test_metrics_vs_reference.py)
    score_doc=lambda doc, pred: {
        "exact_match": M.textvqa_accuracy(
            pred,
            [str(t) for t in (doc["target"]
                              if isinstance(doc["target"], list)
                              else [doc["target"]])]),
    },
    aggregate=_mean_agg("exact_match"),
))

def _mc_letter_acc(doc: dict, pred: str) -> float:
    """MC-letter grade through the extraction cascade (mmmu/utils.py)."""
    if doc.get("choices"):
        index2ans, all_choices = F.get_multi_choice_info(doc["choices"])
        parsed = F.parse_multi_choice_response(pred, all_choices, index2ans)
    else:
        parsed = M.parse_multi_choice(pred)
    return float(parsed == str(doc["target"]).strip().upper())


def _index_mc_map(doc: dict, hint_key: Optional[str] = None) -> dict:
    """AI2D/ScienceQA doc mapping (ai2d/utils.py:7-37,
    scienceqa/utils.py:1-31): choices interpolate as 'A. <text>' lines
    and the integer answer index becomes the letter target."""
    choices = doc.get("choices") or doc.get("options") or []
    choices = [str(c) for c in _parse_options_field(choices)]
    letters = [chr(ord("A") + i) for i in range(len(choices))]
    block = "\n".join(f"{o}. {c}" for o, c in zip(letters, choices))
    prefix = ""
    if hint_key and doc.get(hint_key):
        prefix = f"Context: {doc[hint_key]}\n"
    doc["text"] = f"{prefix}{doc['text']}\n{block}"
    doc["choices"] = choices
    tgt = doc.get("target", doc.get("answer", 0))
    if str(tgt).strip().isdigit():
        doc["target"] = letters[int(tgt)]
    return doc


def _sqa_score(doc: dict, pred: str) -> dict:
    """scienceqa/utils.py:34-44 transcribed exactly: lowered full-string
    letter match ('I know this is weird, but it's how llava parse it');
    the 'X.' prefix branch is dead upstream too (isupper() on an
    already-lowered string), preserved for parity."""
    target = str(doc["target"]).strip().lower()
    p = pred.strip().lower()
    if p == target:
        return {"exact_match": 1.0}
    if len(p) >= 2 and p[0].isupper() and p[1] == ".":
        return {"exact_match": float(p[0] == target)}
    return {"exact_match": 0.0}


register(Task(
    name="ai2d",
    post_prompt=MC_LETTER,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/ai2d",
    doc_mapper=_index_mc_map,
    # reference: flexible MC-regex filter then exact match vs the letter
    # (ai2d.yaml:38-49) — the full extraction cascade approximates it
    score_doc=lambda doc, pred: {
        "exact_match": _mc_letter_acc(doc, pred),
    },
    aggregate=_mean_agg("exact_match"),
))

register(Task(
    name="scienceqa_img",
    post_prompt=MC_LETTER,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/ScienceQA",
    dataset_name="ScienceQA-IMG",
    doc_mapper=lambda d: _index_mc_map(d, hint_key="hint"),
    score_doc=_sqa_score,
    aggregate=_mean_agg("exact_match"),
))

register(Task(
    name="gqa",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/GQA",
    test_split="testdev_balanced",
    score_doc=lambda doc, pred: {
        "acc": M.exact_match(pred, str(doc["target"])),
    },
    aggregate=_mean_agg("acc"),
))

register(Task(
    name="realworldqa",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/RealWorldQA",
    # realworldqa/utils.py:34-43 transcribed: lowered/stripped compare
    # with only a trailing '.' removed from the prediction
    score_doc=lambda doc, pred: {
        "exact_match": float(
            pred.lower().strip().rstrip(".")
            == str(doc["target"]).lower().strip()),
    },
    aggregate=_mean_agg("exact_match"),
))


# ---------------------------------------------------------------------------
# VQA-family, hallucination, MC-benchmark and caption tasks beyond the
# BASELINE set (reference eval/lmms_eval/tasks/{vqav2,ok_vqa,vizwiz_vqa,
# pope,seedbench,mmstar,flickr30k,nocaps,ocrbench})
# ---------------------------------------------------------------------------

def _answers_of(doc) -> list[str]:
    t = doc.get("target")
    if isinstance(t, list):
        return [a["answer"] if isinstance(a, dict) else str(a) for a in t]
    return [str(t)]


def _vqa_score(doc: dict, pred: str) -> dict:
    return {"exact_match": M.vqa_accuracy(pred, _answers_of(doc))}


for _name, _path, _split in (
    ("vqav2_val", "lmms-lab/VQAv2", "validation"),
    ("ok_vqa_val", "lmms-lab/OK-VQA", "val2014"),
    ("vizwiz_vqa_val", "lmms-lab/VizWiz-VQA", "val"),
):
    register(Task(
        name=_name,
        post_prompt=(
            "\nWhen the provided information is insufficient, respond "
            "with 'Unanswerable'.\nAnswer the question using a single "
            "word or phrase." if "vizwiz" in _name else SINGLE_WORD
        ),
        generation_kwargs={"max_new_tokens": 16},
        dataset_path=_path,
        test_split=_split,
        score_doc=_vqa_score,
        aggregate=_mean_agg("exact_match"),
    ))


def _pope_score(doc: dict, pred: str) -> dict:
    # reference POPE compares the RAW lowered/stripped prediction string
    # (pope/utils.py:15-17) — no yes/no extraction; a verbose "Yes, it
    # is." scores wrong upstream too, and the published numbers flow
    # through that strictness
    return {
        "pred": pred.lower().strip(),
        "gt": str(doc["target"]).lower().strip(),
    }


register(Task(
    name="pope",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 16},
    dataset_path="lmms-lab/POPE",
    score_doc=_pope_score,
    aggregate=M.pope_aggregate,
))


def _mc_from_choices_score(doc: dict, pred: str) -> dict:
    if doc.get("choices"):
        index2ans, all_choices = F.get_multi_choice_info(doc["choices"])
        parsed = F.parse_multi_choice_response(pred, all_choices, index2ans)
    else:
        parsed = M.parse_multi_choice(pred)
    return {"acc": float(parsed == str(doc["target"]).strip().upper())}


for _name, _path, _split in (
    ("seedbench", "lmms-lab/SEED-Bench", "test"),
    ("mmstar", "Lin-Chen/MMStar", "val"),
):
    register(Task(
        name=_name,
        post_prompt=MC_LETTER,
        generation_kwargs={"max_new_tokens": 16},
        dataset_path=_path,
        test_split=_split,
        score_doc=_mc_from_choices_score,
        aggregate=_mean_agg("acc"),
    ))


for _name, _path, _split in (
    ("flickr30k_test", "lmms-lab/flickr30k", "test"),
    ("nocaps_val", "lmms-lab/NoCaps", "validation"),
):
    register(Task(
        name=_name,
        post_prompt="",
        generation_kwargs={"max_new_tokens": 32},
        dataset_path=_path,
        test_split=_split,
        doc_mapper=_coco_map,
        score_doc=lambda doc, pred: {
            "prediction": pred,
            "references": _answers_of(doc),
        },
        aggregate=_caption_agg,
    ))


def _ocrbench_score(doc: dict, pred: str) -> dict:
    # containment accuracy (reference tasks/ocrbench/utils.py: answer
    # string contained in the prediction, case-insensitive)
    p = pred.lower().strip()
    ok = any(str(a).lower().strip() in p for a in _answers_of(doc))
    return {"acc": float(ok)}


register(Task(
    name="ocrbench",
    post_prompt=SINGLE_WORD,
    generation_kwargs={"max_new_tokens": 32},
    dataset_path="echo840/OCRBench",
    score_doc=_ocrbench_score,
    aggregate=_mean_agg("acc"),
))


# breadth tranche: the remaining reference task families register on import
from . import tasks_ext  # noqa: E402,F401  (registration side effects)
