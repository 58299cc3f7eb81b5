"""The port's evaluation layer (lavida_mod_tpu_torch.eval) against the JAX
package's (lavida_mod_tpu.eval) on the CPU:

  - the copies (metrics, filters, ifeval, tasks, tasks_ext, tracker) are
    the JAX modules' code, statement for statement (their syntax trees
    equal, docstrings left out); the evaluator's `evaluate`,
    `simple_evaluate` and `mme_dedup_rows`, the CLI's `parse_kv` and the
    smoke tool's `docs_for` and planting likewise;
  - the registry: the same 131 task names, and for every task (one case
    each) the same fields; the documents of scripts/eval_smoke_all.py's
    `docs_for` (jsonl with seeded PNGs) load through both `load_docs` into
    equal documents (images by pixels), give equal prompts, and equal
    filtered predictions, per-document scores and aggregates on fixed
    strings and on the candidates of the script's `plant_candidates`
    (also planted as targets) -- exact: strings and host floats, NaN
    equal to NaN;
  - the metric, filter and IFEval functions give JAX's results, exactly,
    on fixed and seeded generated strings;
  - `evaluate` / `simple_evaluate` with a stub model answering from a CRC
    of the prompt give JAX's results (less the wall and latency keys) and
    make JAX's requests, on a generate task, the `choices`
    log-likelihood route, the target log-likelihood route, the batched
    route and video documents (the stub sees video=True);
  - `shard_docs` / `allgather_rows` are the identity in one process and
    over a two-process gloo group give strided shards and the rows in
    rank order; `mme_dedup_rows` is JAX's;
  - the CLI takes every flag of JAX's with its default (plus --device,
    default cuda), `--tp 2` with a quantized layout or --kv8 exits in
    the JAX CLI's words, and
    `--tiny --device cpu` runs end to end, writing --output and the
    tracker's files.
"""

import ast
import importlib.util
import json
import os
import socket
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import re

import pytest

from lavida_mod_tpu.eval import evaluator as jev
from lavida_mod_tpu.eval import filters as jF
from lavida_mod_tpu.eval import ifeval as jife
from lavida_mod_tpu.eval import metrics as jM
from lavida_mod_tpu.eval import tasks as jtasks
from lavida_mod_tpu_torch.eval import evaluator as tev
from lavida_mod_tpu_torch.eval import filters as tF
from lavida_mod_tpu_torch.eval import ifeval as tife
from lavida_mod_tpu_torch.eval import metrics as tM
from lavida_mod_tpu_torch.eval import tasks as ttasks
from lavida_mod_tpu_torch.tools import eval_smoke_all as tsmoke

REPO = Path(__file__).resolve().parents[1]


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_eval_smoke_all", REPO / "scripts" / "eval_smoke_all.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsmoke = _load_script()


# ---------------------------------------------------------------------------
# equality of values and of code
# ---------------------------------------------------------------------------

def _eq(a, b) -> bool:
    """Equal values: same types, floats exactly (NaN equal to NaN), PIL
    images by size, mode and pixels, containers elementwise."""
    from PIL import Image

    if isinstance(a, Image.Image) or isinstance(b, Image.Image):
        return (isinstance(a, Image.Image) and isinstance(b, Image.Image)
                and a.size == b.size and a.mode == b.mode
                and np.array_equal(np.asarray(a), np.asarray(b)))
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (a != a and b != b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


def _call(f, *args, **kw):
    """f's result, or the type and message of what it raised."""
    try:
        return ("ok", f(*args, **kw))
    except Exception as e:  # noqa: BLE001 -- compared, not hidden
        return ("raised", type(e).__name__, str(e))


def _same(a, b):
    assert _eq(a, b), (a, b)


def _is_doc(node) -> bool:
    return (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str))


def _body(path: Path, names=None) -> list:
    """The module's statements as syntax-tree dumps, every docstring (the
    module's, each class's and function's) left out; with `names`, only
    those top-level definitions."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and len(node.body) > 1 \
                and _is_doc(node.body[0]):
            node.body = node.body[1:]
    body = tree.body[1:] if tree.body and _is_doc(tree.body[0]) \
        else tree.body
    if names is not None:
        body = [n for n in body if getattr(n, "name", None) in names
                or (isinstance(n, ast.Assign)
                    and any(getattr(t, "id", None) in names
                            for t in n.targets))]
        assert len(body) == len(names), names
    return [ast.dump(n) for n in body]


COPIES = ["eval/metrics.py", "eval/filters.py", "eval/ifeval.py",
          "eval/tasks.py", "eval/tasks_ext.py", "eval/tracker.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_jax_modules_code(rel):
    assert _body(REPO / "lavida_mod_tpu_torch" / rel) == \
        _body(REPO / "lavida_mod_tpu" / rel)


@pytest.mark.parametrize("rel,names", [
    ("eval/evaluator.py", ["evaluate", "mme_dedup_rows", "simple_evaluate"]),
    ("eval/__main__.py", ["parse_kv"]),
])
def test_ported_functions_are_the_jax_code(rel, names):
    assert _body(REPO / "lavida_mod_tpu_torch" / rel, names) == \
        _body(REPO / "lavida_mod_tpu" / rel, names)


def test_smoke_tool_builds_the_scripts_documents():
    names = ["N_DOCS", "TEXT_ONLY", "OPTIONS", "base_doc", "docs_for",
             "NOT_CALIBRATABLE", "_row_accepts", "try_plant"]
    assert _body(REPO / "lavida_mod_tpu_torch/tools/eval_smoke_all.py",
                 names) == _body(REPO / "scripts/eval_smoke_all.py", names)
    imgs = [f"img{i}.png" for i in range(4)]
    for name in jtasks.list_tasks():
        assert tsmoke.docs_for(name, imgs) == jsmoke.docs_for(name, imgs)


# ---------------------------------------------------------------------------
# the registry, task by task
# ---------------------------------------------------------------------------

TASKS = jtasks.list_tasks()
FIELDS = ("name", "output_type", "pre_prompt", "post_prompt",
          "generation_kwargs", "dataset_path", "dataset_name", "test_split",
          "max_frames_num")
FIXED = ["yes", "No", "B", "(C) a bird", "The answer is A.", "a dog",
         "2", "10", "#### 4", "0.5", "[10, 10, 50, 50]", "2.0 to 8.5",
         "", "  Yes, there is a dog.", "the sea is blue and wide"]


def test_registry_equals_jax():
    assert ttasks.list_tasks() == TASKS and len(TASKS) == 131


@pytest.fixture(scope="module")
def smoke_dir(tmp_path_factory):
    """The script's documents of every task as <task>.jsonl beside its
    seeded PNGs (the script's own images: 128 x 96, seed 0)."""
    d = tmp_path_factory.mktemp("smoke")
    imgs = tsmoke.write_images(str(d))
    for name in TASKS:
        with open(d / f"{name}.jsonl", "w") as f:
            for doc in jsmoke.docs_for(name, imgs):
                f.write(json.dumps(doc) + "\n")
    return d


def _predictions(jt, jdocs) -> list[str]:
    preds = list(FIXED)
    for doc in jdocs[:2]:
        for p in FIXED[:4]:
            preds += [c for c in jsmoke.plant_candidates(jt, doc, p)
                      if isinstance(c, str)]
        preds += [str(c) for c in doc.get("choices") or ()]
    return list(dict.fromkeys(preds))


def _scores(task, docs, pred):
    filt = [_call(task.apply_filters, pred, dict(d)) for d in docs]
    rows = [_call(task.score_doc, dict(d), f[1]) if task.score_doc
            and f[0] == "ok" else None for d, f in zip(docs, filt)]
    agg = (_call(task.aggregate, [r[1] for r in rows])
           if task.aggregate and all(r and r[0] == "ok" for r in rows)
           else None)
    return filt, rows, agg


@pytest.mark.parametrize("name", TASKS)
def test_task_equals_jax(name, smoke_dir):
    jt, tt = jtasks.get_task(name), ttasks.get_task(name)
    for f in FIELDS:
        _same(getattr(tt, f), getattr(jt, f))
    for f in ("score_doc", "aggregate", "doc_mapper", "filter_ensemble"):
        assert (getattr(tt, f) is None) == (getattr(jt, f) is None), f
    path = str(smoke_dir / f"{name}.jsonl")
    jdocs, tdocs = jt.load_docs(path), tt.load_docs(path)
    _same(tdocs, jdocs)
    _same(tt.load_docs(path, limit=2), jt.load_docs(path, limit=2))
    for jd, td in zip(jdocs, tdocs):
        assert tt.doc_to_text(td) == jt.doc_to_text(jd)
    preds = _predictions(jt, jdocs)
    for pred in preds:
        _same(_scores(tt, tdocs, pred), _scores(jt, jdocs, pred))
    # targets planted as the script plants them (try_plant)
    for pred in preds[:3]:
        for i, jd in enumerate(jdocs[:2]):
            for cand in jsmoke.plant_candidates(jt, jd, pred):
                trials = []
                for d in (jd, tdocs[i]):
                    trial = dict(d)
                    trial["target"] = cand
                    for k in ("answer", "gt"):
                        if k in trial:
                            trial[k] = (cand if not isinstance(cand, list)
                                        else cand[0])
                    trials.append(trial)
                _same(_scores(tt, [trials[1]], pred),
                      _scores(jt, [trials[0]], pred))


def test_video_documents_load_as_jax(tmp_path):
    """A `video` field becomes max_frames_num frames sampled from the GIF
    (32 of 40) with is_video, as JAX's load_docs resolves it."""
    imgs = tsmoke.write_images(str(tmp_path))
    path = tsmoke.write_docs("videomme", str(tmp_path), imgs,
                             video_frames=40)
    jt, tt = jtasks.get_task("videomme"), ttasks.get_task("videomme")
    jdocs, tdocs = jt.load_docs(path, limit=2), tt.load_docs(path, limit=2)
    _same(tdocs, jdocs)
    assert all(d["is_video"] and len(d["images"]) == 32 for d in tdocs)


# ---------------------------------------------------------------------------
# the metric, filter and IFEval functions
# ---------------------------------------------------------------------------

WORDS = ["yes", "no", "Yes.", "NO", "A", "B", "(C)", "D.", "a", "the", "dog",
         "cat", "bird", "fish", "2", "10", "3.5", "1,000", "-4", "50%",
         "1e3", "is", "answer:", "####", "[10,", "20]", "(0.1,", "0.2)",
         "\n", "*", "Ñandú", "日本", "?", "!", ",", "P.S.", "<<title>>",
         "{\"a\": 1}", "***", "zero", "twenty", "two"]


def _strings(seed: int, n: int = 40) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(0, 14))))
            for _ in range(n)] + FIXED


def _cases(fn: str, seed: int):
    """Arguments for metric / filter function `fn` from seeded strings."""
    s = _strings(seed)
    t = _strings(seed + 1)
    rng = np.random.default_rng(seed + 2)
    lists = [[t[i], t[(i + 3) % len(t)]] for i in range(len(t))]
    one = {"normalize_caption", "normalize_answer", "vqa_normalize",
           "parse_bbox", "extract_numbers", "normalize_str",
           "parse_open_response", "mme_parse_pred_ans",
           "extract_final_answer", "normalize_number", "parse_multi_choice",
           "_squad_normalize", "_vqa_punct_digit"}
    if fn in one:
        return [(x,) for x in s]
    if fn in ("anls", "vqa_accuracy", "squad_f1", "textvqa_accuracy"):
        return [(x, lists[i % len(lists)]) for i, x in enumerate(s)]
    if fn in ("relaxed_accuracy", "exact_match", "yes_no_match",
              "norm_edit_similarity", "jaccard_word", "_levenshtein"):
        return list(zip(s, t))
    if fn in ("cider_d", "bleu", "rouge_l"):
        return [(s[:k], lists[:k]) for k in (1, 5, len(s))]
    if fn in ("bbox_iou", "center_in_bbox"):
        boxes = [list(map(float, rng.integers(0, 100, 4))) for _ in range(30)]
        return list(zip(boxes, boxes[3:] + boxes[:3]))
    if fn == "eval_open":
        return [(x, jF.parse_open_response(y)) for x, y in zip(s, t)]
    if fn in ("mmmu_parse_options", "get_multi_choice_info"):
        return [(t[i:i + k],) for i, k in zip(range(0, 40, 4),
                                               [2, 3, 4, 5] * 10)]
    if fn == "parse_multi_choice_response":
        out = []
        for i, x in enumerate(s):
            opts = t[i % 30:i % 30 + 4]
            idx, allc = jF.get_multi_choice_info(opts)
            out.append((x, allc, idx))
        return out
    if fn == "normalize_math_answer":
        return [(x, t[i % 30:i % 30 + 4] if i % 2 else None)
                for i, x in enumerate(s)]
    if fn in ("mme_scores", "mme_aggregate", "pope_aggregate"):
        rows = []
        for i, x in enumerate(s):
            rows.append({"category": ["a", "b"][i % 2],
                         "image_id": str(i // 2), "question_id": str(i // 2),
                         "correct": int(i % 3 == 0), "score": float(i % 3),
                         "pred": jF.mme_parse_pred_ans(x),
                         "gt": ["yes", "no"][i % 2]})
        return [(rows[:k],) for k in (0, 2, 9, len(rows))]
    raise KeyError(fn)


MODULE_FUNCTIONS = [
    (mod, n) for mod, names in (
        ("metrics", ["normalize_caption", "normalize_answer", "cider_d",
                     "bleu", "rouge_l", "_levenshtein", "anls",
                     "relaxed_accuracy", "parse_multi_choice",
                     "exact_match", "yes_no_match", "mme_scores",
                     "_vqa_punct_digit", "vqa_normalize", "vqa_accuracy",
                     "pope_aggregate", "_squad_normalize", "squad_f1",
                     "norm_edit_similarity", "jaccard_word", "parse_bbox",
                     "bbox_iou", "center_in_bbox", "textvqa_accuracy"]),
        ("filters", ["mmmu_parse_options", "get_multi_choice_info",
                     "parse_multi_choice_response", "extract_numbers",
                     "normalize_str", "parse_open_response", "eval_open",
                     "mme_parse_pred_ans", "mme_aggregate",
                     "extract_final_answer", "normalize_math_answer",
                     "normalize_number"]))
    for n in names]


@pytest.mark.parametrize("mod,fn", MODULE_FUNCTIONS)
def test_function_equals_jax(mod, fn):
    jm, tm = {"metrics": (jM, tM), "filters": (jF, tF)}[mod]
    cases = _cases(fn, zlib.crc32(fn.encode()) % 1000)
    assert cases
    for args in cases:
        _same(_call(getattr(tm, fn), *args), _call(getattr(jm, fn), *args))


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_stack_equals_jax(seed):
    """WhitespaceFilter, RegexFilter (default and a capture group),
    MultiChoiceRegexFilter with and without choices, TakeFirst, chained
    in a FilterEnsemble."""
    s = _strings(seed)
    resps = [[x, y] for x, y in zip(s, s[1:] + s[:1])]
    docs = [{"choices": ["a dog", "a cat", "a bird"]} if i % 2 else {}
            for i in range(len(resps))]

    def chains(F):
        return [[F.WhitespaceFilter()], [F.RegexFilter()],
                [F.RegexFilter(r"(\d+)|([A-D])", group_select=-1)],
                [F.MultiChoiceRegexFilter()],
                [F.WhitespaceFilter(), F.MultiChoiceRegexFilter(),
                 F.TakeFirst()]]

    for jc, tc in zip(chains(jF), chains(tF)):
        _same(_call(tF.FilterEnsemble("x", tc).apply, resps, docs),
              _call(jF.FilterEnsemble("x", jc).apply, resps, docs))


IFEVAL_KWARGS = {
    "keywords:existence": {"keywords": ["dog", "sea"]},
    "keywords:frequency": {"keyword": "the", "frequency": 2,
                           "relation": "at least"},
    "keywords:forbidden_words": {"forbidden_words": ["cat"]},
    "keywords:letter_frequency": {"letter": "a", "let_frequency": 3,
                                  "let_relation": "less than"},
    "language:response_language": {"language": "en"},
    "length_constraints:number_sentences": {"num_sentences": 2,
                                            "relation": "at least"},
    "length_constraints:number_paragraphs": {"num_paragraphs": 2},
    "length_constraints:number_words": {"num_words": 5,
                                        "relation": "less than"},
    "length_constraints:nth_paragraph_first_word": {
        "num_paragraphs": 2, "nth_paragraph": 1, "first_word": "the"},
    "detectable_content:number_placeholders": {"num_placeholders": 1},
    "detectable_content:postscript": {"postscript_marker": "P.S."},
    "detectable_format:number_bullet_lists": {"num_bullets": 1},
    "detectable_format:constrained_response": {},
    "detectable_format:number_highlighted_sections": {"num_highlights": 1},
    "detectable_format:multiple_sections": {"section_spliter": "Section",
                                            "num_sections": 2},
    "detectable_format:json_format": {},
    "detectable_format:title": {},
    "combination:two_responses": {},
    "combination:repeat_prompt": {"prompt_to_repeat": "the dog"},
    "startend:end_checker": {"end_phrase": "two"},
    "startend:quotation": {},
    "change_case:capital_word_frequency": {"capital_frequency": 1,
                                           "capital_relation": "at least"},
    "change_case:english_capital": {},
    "change_case:english_lowercase": {},
    "punctuation:no_comma": {},
}


def test_ifeval_checks_equal_jax():
    assert set(tife.REGISTRY) == set(jife.REGISTRY) == set(IFEVAL_KWARGS)
    texts = _strings(7, 60) + [
        "the dog\n\nthe sea. Two!", "* a\n* b\nP.S. two", '"quoted two"',
        '{"a": 1}', "<<Title>>\nSection 1 a\nSection 2 b",
        "first ****** second", "My answer is yes.", "[name] is *here*"]
    rows_j, rows_t = [], []
    for inst, kw in IFEVAL_KWARGS.items():
        for text in texts:
            _same(_call(tife.check_instruction, inst, text, kw),
                  _call(jife.check_instruction, inst, text, kw))
    ids = list(IFEVAL_KWARGS)
    for i, text in enumerate(texts):
        doc = {"instruction_id_list": ids[i % 20:i % 20 + 3],
               "kwargs": [IFEVAL_KWARGS[k] for k in ids[i % 20:i % 20 + 3]]}
        rj, rt = jife.score_ifeval(doc, text), tife.score_ifeval(doc, text)
        _same(rt, rj)
        rows_j.append(rj)
        rows_t.append(rt)
    _same(tife.aggregate_ifeval(rows_t), jife.aggregate_ifeval(rows_j))


# ---------------------------------------------------------------------------
# the evaluator with a stub model
# ---------------------------------------------------------------------------

STUB_WORDS = ["yes", "no", "A", "B", "C", "a dog", "2", "the cat"]


class StubModel:
    """Answers from a CRC of the prompt; records every request."""

    def __init__(self):
        self.calls = []
        self.latencies = []

    def generate_until(self, text, images, gen_kwargs=None, video=False):
        self.calls.append(("one", text, len(images), video,
                           sorted((gen_kwargs or {}).items())))
        return STUB_WORDS[zlib.crc32(text.encode()) % len(STUB_WORDS)]

    def generate_until_batch(self, texts, images_list, gen_kwargs=None):
        self.calls.append(("batch", list(texts),
                           [len(i) for i in images_list],
                           sorted((gen_kwargs or {}).items())))
        return [STUB_WORDS[zlib.crc32(t.encode()) % len(STUB_WORDS)]
                for t in texts]

    def loglikelihood(self, text, images, continuation):
        self.calls.append(("ll", text, len(images), continuation))
        return -(zlib.crc32((text + continuation).encode()) % 997) / 10.0

    @property
    def avg_latency(self):
        return 0.0


TIMING = ("wall_s", "avg_latency_s")


def _untimed(out):
    res = {k: v for k, v in out["results"].items() if k not in TIMING}
    assert set(TIMING) <= set(out["results"])
    return {**out, "results": res}


def _docs(smoke_dir, name, jax=True):
    task = (jtasks if jax else ttasks).get_task(name)
    return task, task.load_docs(str(smoke_dir / f"{name}.jsonl"))


@pytest.mark.parametrize("route", ["generate", "choices", "target",
                                   "batched", "video", "video_batched"])
def test_evaluate_equals_jax(route, smoke_dir, tmp_path):
    if route.startswith("video"):
        imgs = tsmoke.write_images(str(tmp_path))
        tsmoke.write_docs("videomme", str(tmp_path), imgs, video_frames=8)
        src, name = tmp_path, "videomme"
    else:
        src = smoke_dir
        name = {"generate": "pope", "choices": "hellaswag",
                "target": "hellaswag", "batched": "mme"}[route]
    (jt, jdocs), (tt, tdocs) = _docs(src, name), _docs(src, name, False)
    if route == "target":
        for d in jdocs + tdocs:
            d.pop("choices")
    bs = 3 if route in ("batched", "video_batched") else 1
    outs, calls = [], []
    for ev, task, docs in ((jev, jt, jdocs), (tev, tt, tdocs)):
        stub = StubModel()
        outs.append(ev.evaluate(stub, task, docs, {"max_new_tokens": 8},
                                log_samples=True, progress=False,
                                batch_size=bs, distributed=True))
        calls.append(stub.calls)
    _same(_untimed(outs[1]), _untimed(outs[0]))
    _same(calls[1], calls[0])
    if route.startswith("video"):
        assert all(c[0] == "one" and c[3] is True for c in calls[1])
        assert all(c[2] == 8 for c in calls[1])     # all 8 frames of 8
    if route == "choices":
        assert len(calls[1]) == 4 * len(tdocs)


def test_simple_evaluate_and_tracker_equal_jax(smoke_dir, tmp_path):
    from lavida_mod_tpu.eval.tracker import EvaluationTracker as JTracker
    from lavida_mod_tpu_torch.eval.tracker import EvaluationTracker

    names = ["pope", "hellaswag", "ifeval"]
    paths = {n: str(smoke_dir / f"{n}.jsonl") for n in names}
    outs = []
    for ev, tracker, tag in ((jev, JTracker, "jax"),
                             (tev, EvaluationTracker, "port")):
        tr = tracker(str(tmp_path / tag), model_name="tiny/model")
        res = ev.simple_evaluate(StubModel(), names, paths, limit=3,
                                 gen_kwargs={"max_new_tokens": 4},
                                 log_samples=True,
                                 output_path=str(tmp_path / f"{tag}.json"),
                                 tracker=tr)
        on_disk = json.loads((tmp_path / f"{tag}.json").read_text())
        files = sorted(os.listdir(tmp_path / tag / "tiny__model"))
        saved = json.loads((tmp_path / tag / "tiny__model" /
                            files[0]).read_text())
        outs.append(({t: _untimed(r) for t, r in res.items()},
                     {t: _untimed(r) for t, r in on_disk.items()},
                     [f.rsplit("_", 1)[0] for f in files],
                     sorted(saved), sorted(saved["config"])))
    _same(outs[1], outs[0])
    assert outs[1][2] == ["results", "samples_hellaswag", "samples_ifeval",
                          "samples_pope"]


# ---------------------------------------------------------------------------
# the distributed pieces
# ---------------------------------------------------------------------------

def test_mme_dedup_and_single_process_identity():
    rows = [{"question_id": str(i % 4), "score": float(i)} for i in range(12)]
    rows += [{"image_id": "x", "score": 1.0}] * 3
    _same(tev.mme_dedup_rows(rows), jev.mme_dedup_rows(rows))
    assert len(tev.mme_dedup_rows(rows)) == 10
    docs = [{"id": i} for i in range(5)]
    assert tev.shard_docs(docs) is docs
    assert tev.allgather_rows(rows) == rows
    _same(tev.allgather_rows(rows), jev.allgather_rows(rows))


_GLOO = """
import json, sys
import torch.distributed as dist
from lavida_mod_tpu_torch.eval import evaluator as ev
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
docs = [{"id": i} for i in range(7)]
mine = ev.shard_docs(docs)
rows = [{"rank": rank, "id": d["id"], "t": (1, 2)} for d in mine]
print(json.dumps({"shard": [d["id"] for d in mine],
                  "rows": ev.allgather_rows(rows)}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_shard_and_gather_over_two_gloo_ranks():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r),
                               str(port)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    assert got[0]["shard"] == [0, 2, 4, 6] and got[1]["shard"] == [1, 3, 5]
    # rank 0's rows, then rank 1's; through json, as JAX's gather
    want = [{"rank": 0, "id": i, "t": [1, 2]} for i in (0, 2, 4, 6)] + \
        [{"rank": 1, "id": i, "t": [1, 2]} for i in (1, 3, 5)]
    assert got[0]["rows"] == got[1]["rows"] == want


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _jax_flags() -> dict:
    """JAX __main__'s add_argument calls: {flag: {keyword: constant}}."""
    tree = ast.parse((REPO / "lavida_mod_tpu/eval/__main__.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "choices", "action", "required")}
            if any(k.arg == "type" for k in node.keywords):
                kw["type"] = next(k.value.id for k in node.keywords
                                  if k.arg == "type")
            out[node.args[0].value] = kw
    return out


def test_cli_takes_every_jax_flag_with_its_default():
    from lavida_mod_tpu_torch.eval.__main__ import build_parser

    acts = {a.option_strings[0]: a for a in build_parser()._actions
            if a.option_strings and a.option_strings[0].startswith("--")}
    jflags = _jax_flags()
    assert set(acts) - set(jflags) == {"--device"}
    assert len(jflags) == 16
    for flag, kw in jflags.items():
        a = acts[flag]
        assert a.default == kw.get("default", False if kw.get("action") ==
                                   "store_true" else None), flag
        assert a.choices == kw.get("choices"), flag
        assert a.required == kw.get("required", False), flag
        if "type" in kw:
            assert a.type is int, flag
    assert acts["--device"].default == "cuda"
    assert acts["--quant"].default == "int8"
    assert acts["--mc-num"].default == 16


@pytest.mark.parametrize("extra,words", [
    ([], "--tp is bf16 serving; use --quant none"),
    (["--quant", "int4"], "--tp is bf16 serving; use --quant none"),
    (["--quant", "none", "--kv8"], "--tp is bf16 serving; drop --kv8")])
def test_cli_tp_exits_naming_the_item(tmp_path, extra, words):
    """--tp is bf16 serving: with a quantized layout or the int8 KV cache
    the CLI exits in the JAX CLI's words (eval/__main__.py:96-101), before
    it reads the checkpoint or any document (sharded eval itself:
    tests/test_torch_parallel.py)."""
    from lavida_mod_tpu_torch.eval.__main__ import main

    with pytest.raises(SystemExit, match=re.escape(words)):
        main(["--model-path", str(tmp_path / "none"), "--device", "cpu",
              "--tasks", "pope", "--tp", "2", *extra])


def test_cli_tiny_runs_on_the_cpu(smoke_dir, tmp_path):
    """python -m lavida_mod_tpu_torch.eval --tiny --device cpu over an
    image, a log-likelihood and a video task: --output holds each task's
    results and samples with JAX's keys, the tracker its files."""
    imgs = tsmoke.write_images(str(tmp_path))
    video = tsmoke.write_docs("videomme", str(tmp_path), imgs,
                              video_frames=4)
    out, outdir = tmp_path / "res.json", tmp_path / "trk"
    cmd = [sys.executable, "-m", "lavida_mod_tpu_torch.eval", "--tiny",
           "--device", "cpu", "--tasks", "pope,hellaswag,videomme",
           "--data-path", f"pope={smoke_dir / 'pope.jsonl'},"
           f"hellaswag={smoke_dir / 'hellaswag.jsonl'},videomme={video}",
           "--limit", "2", "--mc-num", "4",
           "--gen-kwargs", "max_new_tokens=4,prefix_lm=True",
           "--output", str(out), "--output-dir", str(outdir)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(out.read_text())
    want = {}
    for name, path in (("pope", smoke_dir / "pope.jsonl"),
                       ("hellaswag", smoke_dir / "hellaswag.jsonl"),
                       ("videomme", Path(video))):
        jt = jtasks.get_task(name)
        want[name] = jev.evaluate(StubModel(), jt, jt.load_docs(
            str(path), limit=2), log_samples=True, progress=False)
    assert list(res) == list(want)
    for name in want:
        assert set(res[name]) == set(want[name]) == {"task", "results",
                                                     "samples"}
        assert list(res[name]["results"]) == list(want[name]["results"])
        assert res[name]["results"]["n_docs"] == 2
        assert [set(s) for s in res[name]["samples"]] == \
            [set(s) for s in want[name]["samples"]]
    files = sorted(os.listdir(outdir / "tiny"))
    assert [f.rsplit("_", 1)[0] for f in files] == [
        "results", "samples_hellaswag", "samples_pope", "samples_videomme"]


def test_chip_smoke_eval_keys_are_jax_result_keys(smoke_dir):
    """chip_smoke's eval phase holds each task's --output results to
    EVAL_KEYS: JAX's evaluate gives those keys, in that order."""
    import chip_smoke

    assert chip_smoke.EVAL_TASKS == ("pope", "textvqa_val", "hellaswag",
                                     "videomme")
    for name in chip_smoke.EVAL_TASKS:
        jt = jtasks.get_task(name)
        out = jev.evaluate(StubModel(), jt, jt.load_docs(
            str(smoke_dir / f"{name}.jsonl"), limit=2), progress=False)
        assert list(out["results"]) == chip_smoke.EVAL_KEYS[name], name
        assert jt.generation_kwargs.get("max_new_tokens",
                                        chip_smoke.EVAL_G) == \
            chip_smoke.EVAL_G
