"""Registry-wide eval smoke: run EVERY registered task family end-to-end
through the port -- the port of scripts/eval_smoke_all.py.

For each family it synthesizes schema-matching docs (jsonl -> load_docs ->
doc_mapper -> prompt build -> tiny-model generation/loglikelihood -> filter
chain -> score_doc -> aggregate) and checks

  1. the full pipeline does not throw, and
  2. the score is NONZERO when the target is planted from the model's own
     (deterministic) prediction -- proving parse/filter/score form a
     consistent chain, not just that exceptions are absent.  Tasks whose
     score cannot be forced by choosing a target (loglikelihood ranking,
     bbox-IoU against a random generator, span-IoU) are checked for (1)
     plus a finite in-range score and reported as "no-throw".

`docs_for`, `plant_candidates` and `try_plant` are the script's
(tests/test_torch_eval.py holds `docs_for` equal to it); `write_docs`
writes a family's documents as jsonl beside seeded PNGs, or, for a video
family, beside a seeded animated GIF of `video_frames` frames that the
documents name in a `video` field (the eval then samples the task's
`max_frames_num` frames from it).

  python -m lavida_mod_tpu_torch.tools.eval_smoke_all --device cpu
  python -m lavida_mod_tpu_torch.tools.eval_smoke_all --tasks pope,mme \
      --device cpu --workdir /tmp/eval_smoke_all
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

N_DOCS = 4


# ---------------------------------------------------------------------------
# synthetic docs
# ---------------------------------------------------------------------------

# text-only families: no image field (the adapter would otherwise splice
# vision tokens into prompts the reference serves as pure text)
TEXT_ONLY = {
    "gsm8k", "mmlu", "mmlu_pro", "arc_challenge", "arc_easy", "gpqa_main",
    "openhermes", "ifeval", "hellaswag",
}

OPTIONS = ["a dog", "a cat", "a bird", "a fish"]


def base_doc(i: int, img: str) -> dict:
    """Generic superset doc: _normalize_doc maps question/answer/image and
    options onto the canonical schema; most mappers .get() what they need."""
    return {
        "question": f"Is there a dog in region {i}?",
        "answer": "B",
        "image": img,
        "options": list(OPTIONS),
        "question_id": str(i // 2),
        "category": "existence",
    }


def docs_for(task_name: str, imgs: list[str]) -> list[dict]:
    docs = []
    for i in range(N_DOCS):
        d = base_doc(i, imgs[i])
        if task_name in TEXT_ONLY:
            d.pop("image")
        # --- per-family schema overrides (each mirrors the HF dataset
        # fields the task's doc_mapper/score_doc read) ---
        if task_name == "gsm8k":
            d["question"] = (f"Tom has {i} apples and buys {i + 2} more. "
                             "How many apples does Tom have?")
            d["answer"] = f"reasoning...\n#### {2 * i + 2}"
        elif task_name == "hellaswag":
            d.pop("options")
            d["ctx"] = f"A person picks up item {i} and"
            d["endings"] = ["puts it down.", "eats the sky.",
                            "flies away.", "becomes a number."]
            d["label"] = str(i % 4)
        elif task_name in ("mmlu", "mmlu_pro", "arc_challenge", "arc_easy",
                           "gpqa_main"):
            d["subject"] = "testing"
        elif task_name == "ifeval":
            d["prompt"] = ("Write a short sentence about the sea, "
                           "in english lowercase only.")
            d["instruction_id_list"] = ["change_case:english_lowercase"]
            d["kwargs"] = [{}]
            d.pop("options")
        elif task_name == "seedbench_2":
            for k, v in zip("abcd", OPTIONS):
                d[f"choice_{k}"] = v
            d["answer"] = "B"
            d["data_type"] = "image"
        elif task_name == "seedbench":
            d["choices"] = list(OPTIONS)
        elif task_name.endswith("_bbox_rec_val") or task_name == \
                "screenspot_rec_test":
            d["bbox"] = [10, 10, 50, 50]
            d["answer"] = "the red square"
        elif task_name == "charades_sta":
            d["timestamp"] = [2.0, 8.5]
            d["answer"] = "2.0 to 8.5"
        elif task_name == "av_odyssey":
            d["options"] = [f"{L}. {o}" for L, o in zip("ABCD", OPTIONS)]
            d["subfield"] = "timbre"
        elif task_name == "conbench":
            d["question_field"] = ["N/Y", "Choices", "Q/A"][i % 3]
            d["answer"] = ["yes", "b", "a dog"][i % 3]
            d["image_id"] = str(i // 2)
        elif task_name in ("livexiv_tqa", "livexiv_vqa"):
            for k, v in zip("abcd", OPTIONS):
                d[f"option_{k}"] = v
            d["gt"] = "B"
        elif task_name in ("mmbench_en_dev", "mmbench_cn_dev"):
            for k, v in zip("ABCD", OPTIONS):
                d[k] = v
            d["hint"] = "A test hint."
        elif task_name in ("jmmmu", "mmmu_val", "cmmmu_val",
                           "mmmu_pro_standard"):
            d["question"] = f"<image 1> Is there a dog in region {i}?"
            d["question_type"] = "multiple-choice"
            d["options"] = str(OPTIONS)  # stringified list (MMMU quirk)
        elif task_name == "synthdog_en":
            d["ground_truth"] = json.dumps(
                {"gt_parse": {"text_sequence": f"sample text {i}"}})
        elif task_name in ("textcaps_val",):
            d["caption_str"] = [f"a photo of object {i}",
                                f"object {i} on a table"]
        elif task_name in ("coco2017_cap_val_lite", "flickr30k_test",
                           "nocaps_val", "detailcaps", "vdc", "vatex_test",
                           "youcook2_val", "screenspot_reg_test") or \
                task_name.endswith("_bbox_val"):
            d["answer"] = [f"a photo of object {i}",
                           f"object {i} on a table"]
        elif task_name == "mme":
            d["answer"] = "yes" if i % 2 else "no"
        elif task_name == "pope":
            d["answer"] = "yes" if i % 2 else "no"
            d.pop("options")
        elif task_name == "hallusion_bench_image":
            d["answer"] = "1" if i % 2 else "0"
            d["set_id"] = str(i // 2)
            d["figure_id"] = str(i % 2)
        elif task_name == "naturalbench":
            d["answer"] = "yes" if i % 2 else "no"
            d["index"] = i
        elif task_name in ("mathvista_testmini", "mathvista_test",
                           "mathverse_testmini", "mathvision_test",
                           "olympiadbench"):
            d["query"] = f"What is {i} + {i}?"
            d["answer"] = str(2 * i)
            d["question_type"] = "free_form"
            d["answer_type"] = "integer"
            d.pop("options")
        elif task_name == "megabench":
            d["task_name"] = "smoke"
        elif task_name == "vcr_wiki_en_easy" or \
                task_name.startswith("vcr_wiki"):
            d["caption"] = f"The crossed out words are sample {i}."
            d["crossed_text"] = [f"sample {i}"]
        elif task_name in ("multidocvqa_val", "docvqa_val", "infovqa_val",
                           "stvqa", "textvqa_val", "websrc_val",
                           "realworldqa", "chartqa", "gqa", "gqa_ru",
                           "ocrbench", "activitynetqa"):
            d["answer"] = "a dog"
            d.pop("options")
        elif task_name in ("vqav2_val", "ok_vqa_val", "vizwiz_vqa_val"):
            d["answers"] = ["a dog"] * 10
            d.pop("options")
        docs.append(d)
    return docs


# ---------------------------------------------------------------------------
# calibration: plant the model's own prediction as the target
# ---------------------------------------------------------------------------

# families where no target choice can force a nonzero score from an
# arbitrary prediction (ranking/IoU/format-dependent); no-throw + finite
# score is the contract
NOT_CALIBRATABLE = {
    "hellaswag",                      # loglikelihood ranking
    "charades_sta",                   # needs "S to E" numerals in pred
    "ifeval",                         # needs instruction-following output
    "refcoco+_bbox_rec_val", "refcoco_bbox_rec_val",
    "refcocog_bbox_rec_val", "screenspot_rec_test",   # bbox parse
    "vcr_wiki_en_easy", "vcr_wiki_en_hard",
    "vcr_wiki_zh_easy", "vcr_wiki_zh_hard",           # exact span recall
}


def plant_candidates(task, doc: dict, pred: str) -> list:
    """Target values that could make score_doc(doc, pred) positive."""
    from ..eval import filters as F

    filt = task.apply_filters(pred, doc)
    cands = [filt, pred, str(filt).strip().lower()]
    if doc.get("choices"):
        index2ans, all_choices = F.get_multi_choice_info(doc["choices"])
        parsed = F.parse_multi_choice_response(filt, all_choices, index2ans)
        cands = [parsed, index2ans.get(parsed, parsed)] + cands
    # parse-family outputs (mme's Otter parse maps to yes/no/other;
    # livexiv-style first-char parses)
    cands += [F.mme_parse_pred_ans(str(pred)), "yes", "no",
              str(filt).strip()[:1], str(filt).strip()[:1].upper()]
    # caption-style list targets
    cands.append([str(filt), "distractor reference"])
    # gsm8k-style extraction targets
    cands.append(f"planted\n#### {filt}")
    return cands


def _row_accepts(row: dict, cand, filt) -> bool:
    """A plant lands if the row shows a positive metric — or if the row is
    a pass-through (no numeric metrics; scoring happens in the aggregate,
    e.g. pope's pred/gt rows, caption references) and the candidate is the
    filtered prediction itself."""
    numeric = {k: v for k, v in row.items()
               if k not in ("id", "image_id", "question_id")
               and isinstance(v, (int, float)) and not isinstance(v, bool)}
    if any(v > 0 for v in numeric.values()):
        return True
    if not numeric:
        c = cand[0] if isinstance(cand, list) else cand
        return str(c).strip().lower() == str(filt).strip().lower()
    return False


def try_plant(task, docs: list[dict], preds: list[str]) -> bool:
    """Mutate docs so score_doc(doc, pred) > 0 where possible.  Returns
    True if at least one doc was successfully planted."""
    any_planted = False
    for doc, pred in zip(docs, preds):
        if task.score_doc is None:
            continue
        filt = task.apply_filters(pred, doc)
        for cand in plant_candidates(task, doc, pred):
            trial = dict(doc)
            trial["target"] = cand
            # some scorers read the raw answer fields
            for k in ("answer", "gt"):
                if k in trial:
                    trial[k] = cand if not isinstance(cand, list) else cand[0]
            try:
                row = task.score_doc(trial, task.apply_filters(pred, trial))
            except Exception:
                continue
            if _row_accepts(row, cand, filt):
                doc.update(trial)
                any_planted = True
                break
    return any_planted


VIDEO_TASKS = ("videomme", "activitynetqa", "videochatgpt_gen",
               "video_detail_description")


def write_images(workdir: str, n: int = N_DOCS, seed: int = 0,
                 size: tuple[int, int] = (128, 96)) -> list[str]:
    """n seeded RGB PNGs (width, height = size) in workdir; their names."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                     dtype=np.uint8)).save(
            os.path.join(workdir, name))
        names.append(name)
    return names


def write_video(path: str, frames: int = 32, seed: int = 0,
                size: tuple[int, int] = (96, 96)) -> str:
    """An animated GIF of `frames` seeded frames (width, height = size)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    ims = [Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                        dtype=np.uint8))
           for _ in range(frames)]
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=40,
                loop=0)
    return path


def write_docs(task_name: str, workdir: str, imgs: list[str],
               video_frames: int = 0) -> str:
    """The family's `docs_for` documents as <workdir>/<task>.jsonl; with
    video_frames > 0 each document's image is replaced by a `video` field
    naming a seeded GIF of that many frames.  Returns the jsonl path."""
    docs = docs_for(task_name, imgs)
    if video_frames:
        for i, d in enumerate(docs):
            name = f"{task_name}_video{i}.gif"
            write_video(os.path.join(workdir, name), video_frames, seed=i)
            d.pop("image", None)
            d["video"] = name
    path = os.path.join(workdir, f"{task_name}.jsonl")
    with open(path, "w") as f:
        for d in docs:
            f.write(json.dumps(d) + "\n")
    return path


# ---------------------------------------------------------------------------


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", default=None,
                    help="comma list; default = every registered family")
    ap.add_argument("--workdir", default="eval_smoke_all")
    ap.add_argument("--max-new-tokens", type=int, default=24,
                    help="global gen cap for speed (the schema/scoring "
                         "path is what's under test, not gen length)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..eval.__main__ import ToyTokenizer
    from ..eval.adapter import LavidaEvalModel
    from ..eval.evaluator import evaluate
    from ..eval.tasks import get_task, list_tasks
    from ..models.lavida import LaViDa
    from ..predict import tiny_config

    os.makedirs(args.workdir, exist_ok=True)
    imgs = write_images(args.workdir)

    # same tiny setup as `python -m lavida_mod_tpu_torch.eval --tiny`
    model = LaViDa.random_init(tiny_config(), 0, torch.float32,
                               torch.device(args.device))

    class _WordTokenizer(ToyTokenizer):
        # decode to real words so parse families (yes/no, MC letters,
        # numerals) can engage with the predictions
        _WORDS = ["yes", "no", "A", "B", "C", "D", "2", "10", "dog",
                  "cat", "the", "sea", "a dog", "0.5", "left", "right"]

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(self._WORDS[int(i) % len(self._WORDS)]
                            for i in ids)

    adapter = LavidaEvalModel(model, _WordTokenizer(), conv_template="llada")

    names = (args.tasks.split(",") if args.tasks else list_tasks())
    rows, failures = [], []
    for name in names:
        task = get_task(name)
        jsonl = write_docs(name, args.workdir, imgs)
        status, calibrated, err = "ok", "-", ""
        try:
            docs = task.load_docs(jsonl)
            gen = {"max_new_tokens": min(
                args.max_new_tokens,
                task.generation_kwargs.get("max_new_tokens", 1 << 30)),
                "prefix_lm": True}
            r1 = evaluate(adapter, task, docs, gen_kwargs=gen,
                          log_samples=True, progress=False)
            if task.output_type == "generate_until" and \
                    name not in NOT_CALIBRATABLE:
                preds = [s["prediction"] for s in r1["samples"]]
                if try_plant(task, docs, preds):
                    r2 = evaluate(adapter, task, docs, gen_kwargs=gen,
                                  progress=False)
                    nums = {k: v for k, v in r2["results"].items()
                            if isinstance(v, (int, float))}
                    calibrated = ("nonzero" if any(v > 0
                                                   for v in nums.values())
                                  else "ZERO")
                else:
                    calibrated = "NO-PLANT"
            # finite-score sanity on run 1
            for k, v in r1["results"].items():
                if isinstance(v, float) and (v != v or abs(v) > 1e9):
                    raise ValueError(f"non-finite metric {k}={v}")
        except Exception:
            status, err = "THROW", traceback.format_exc(limit=3)
        if status != "ok" or calibrated in ("ZERO", "NO-PLANT"):
            failures.append((name, status, calibrated, err))
        rows.append((name, status, calibrated))
        print(f"{name:40s} {status:6s} {calibrated}", flush=True)

    n_ok = sum(r[1] == "ok" for r in rows)
    n_cal = sum(r[2] == "nonzero" for r in rows)
    print(f"\n{n_ok}/{len(rows)} families executed without throwing; "
          f"{n_cal} calibrated nonzero")
    if failures:
        print("\nFAILURES:")
        for name, status, calibrated, err in failures:
            print(f"--- {name} [{status}/{calibrated}]\n{err}")
        sys.exit(1)
    return rows


if __name__ == "__main__":
    main()
