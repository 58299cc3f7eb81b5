"""Eval score-regression harness of the port: run a fixed task subset on
synthetic documents across git revisions and diff the per-task scores
(the counterpart of the repo's scripts/eval_regression.py, on the port's
eval CLI).

It writes deterministic synthetic jsonl documents per task (each in the
schema its task's score_doc reads) and seeded PNGs, plants the working
tree's own predictions as the targets of the even documents (so scores
are not all zero and a broken scorer cannot pass as "no change"), then
runs `python -m lavida_mod_tpu_torch.eval --tiny --device cpu` (the tiny
seeded model, greedy) from the working tree and from each revision, and
compares metric for metric.  With identical code the scores are
bit-identical; a difference is a change in prompting, generation,
filtering or scoring.

Usage:
  python -m lavida_mod_tpu_torch.tools.eval_regression --revs HEAD~1
  python -m lavida_mod_tpu_torch.tools.eval_regression --revs main,topic
  python -m lavida_mod_tpu_torch.tools.eval_regression --tasks chartqa,pope --limit 4

Exit status 1 when any |score difference| exceeds --threshold (default
1e-9: exact).  Each revision is checked out with `git worktree add
--detach` under --workdir (the working tree is never touched) and removed
after.  --repo names the repository (default: the one holding this file).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# one task per scoring family: relaxed-accuracy VQA, strict string compare
# with a ratio aggregate, CIDEr captions, regex-filtered math, MME's
# category pairs
DEFAULT_TASKS = "chartqa,pope,coco2017_cap_val_lite,gsm8k,mme"


def make_fixtures(workdir: str, tasks: list[str], n: int) -> dict:
    """Write n deterministic documents per task (and n seeded PNGs);
    returns {task: jsonl path}."""
    import numpy as np
    from PIL import Image

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(0)
    img_names = []
    for i in range(n):
        p = os.path.join(workdir, f"img{i}.png")
        if not os.path.exists(p):
            Image.fromarray(
                rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)).save(p)
        img_names.append(f"img{i}.png")

    def docs_for(task: str):
        for i in range(n):
            img = img_names[i]
            if task == "pope":
                yield {"text": f"Is there a dog in object {i}?",
                       "target": "yes" if i % 2 else "no", "image": img}
            elif task == "gsm8k":
                yield {"text": f"Tom has {i} apples and buys {i + 2} "
                               f"more. How many apples does Tom have?",
                       "target": f"reasoning...\n#### {2 * i + 2}"}
            elif task == "coco2017_cap_val_lite":
                yield {"text": "placeholder",  # the doc mapper overwrites
                       "target": [f"a photo of object {i}",
                                  f"object {i} on a table"],
                       "image": img}
            elif task == "mme":
                # MME pairs two rows per question_id for its acc+ metric
                yield {"text": f"Is this image number {i}? Answer yes "
                               "or no.", "target": "yes" if i % 2 else "no",
                       "question_id": str(i // 2),
                       "category": "existence", "image": img}
            else:  # the generic VQA schema (chartqa and most others)
                yield {"text": f"What is the value of bar {i}?",
                       "target": str(10 * i + 2), "image": img}

    paths = {}
    for t in tasks:
        p = os.path.join(workdir, f"{t}.jsonl")
        with open(p, "w") as f:
            for d in docs_for(t):
                f.write(json.dumps(d) + "\n")
        paths[t] = p
    return paths


def run_eval(tree: str, tasks: list[str], data_paths: dict, limit: int,
             out_path: str, log_samples: bool = False) -> dict:
    """The port's eval CLI from source tree `tree` (tiny model, CPU)."""
    env = dict(os.environ, PYTHONPATH=tree)
    cmd = [
        sys.executable, "-m", "lavida_mod_tpu_torch.eval", "--tiny",
        "--device", "cpu", "--tasks", ",".join(tasks),
        "--data-path", ",".join(f"{t}={p}" for t, p in data_paths.items()),
        "--limit", str(limit), "--output", out_path,
    ] + (["--log-samples"] if log_samples else [])
    r = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                       text=True)
    if r.returncode != 0:
        print(r.stdout[-2000:], file=sys.stderr)
        print(r.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"eval failed in {tree}")
    with open(out_path) as f:
        return json.load(f)


def calibrate_fixtures(repo: str, fixtures: dict, limit: int, workdir: str):
    """Plant the working tree's predictions as the targets of the even
    documents, so matches and mismatches both flow through every task's
    parse / filter / score path."""
    cal = run_eval(repo, list(fixtures), fixtures, limit,
                   os.path.join(workdir, "calibration.json"),
                   log_samples=True)
    for task, path in fixtures.items():
        preds = {s["id"]: s["prediction"]
                 for s in cal.get(task, {}).get("samples", [])}
        with open(path) as f:
            docs = [json.loads(line) for line in f]
        for i, d in enumerate(docs):
            p = preds.get(d.get("id", i), preds.get(i))
            if p is None or i % 2:
                continue
            if task == "gsm8k":
                d["target"] = f"planted\n#### {p}"
            elif task == "coco2017_cap_val_lite":
                d["target"] = [p, d["target"][0] if
                               isinstance(d["target"], list) else "x"]
            else:  # strict / relaxed string compare families
                d["target"] = p
        with open(path, "w") as f:
            for d in docs:
                f.write(json.dumps(d) + "\n")


def scores_of(results: dict) -> dict:
    """{task: {results: {...}}} -> {task/metric: float}, timings left out."""
    flat = {}
    for task, r in results.items():
        for k, v in r.get("results", {}).items():
            if isinstance(v, (int, float)) and k != "n_docs" \
                    and not k.endswith("_s"):
                flat[f"{task}/{k}"] = float(v)
    return flat


def diff_table(runs: dict, threshold: float) -> tuple[list[str], float]:
    """The markdown table of every metric across the runs (differences
    above the threshold in bold) and the largest difference."""
    keys = sorted({k for s in runs.values() for k in s})
    names = list(runs)
    lines = ["| metric | " + " | ".join(names) + " | max diff |",
             "|---" * (len(names) + 2) + "|"]
    worst = 0.0
    for k in keys:
        vals = [runs[n].get(k) for n in names]
        nums = [v for v in vals if v is not None]
        diff = (max(nums) - min(nums)) if len(nums) > 1 else float("nan")
        worst = max(worst, diff if diff == diff else worst)
        cells = [f"{v:.6f}" if v is not None else "-" for v in vals]
        flag = f"**{diff:.2e}**" if diff > threshold else f"{diff:.1e}"
        lines.append(f"| {k} | " + " | ".join(cells) + f" | {flag} |")
    return lines, worst


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--revs", default="HEAD",
                    help="comma-separated git revisions to compare with "
                         "the working tree")
    ap.add_argument("--tasks", default=DEFAULT_TASKS)
    ap.add_argument("--limit", type=int, default=6)
    ap.add_argument("--threshold", type=float, default=1e-9)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "eval_regression"))
    ap.add_argument("--repo", default=REPO,
                    help="the git repository (its working tree is run)")
    args = ap.parse_args(argv)

    repo = os.path.abspath(args.repo)
    tasks = args.tasks.split(",")
    fixtures = make_fixtures(args.workdir, tasks, args.limit)
    print("[regression] calibrating fixtures (planting worktree "
          "predictions as even-doc targets)")
    calibrate_fixtures(repo, fixtures, args.limit, args.workdir)

    runs = {}
    print(f"[regression] worktree: {repo}")
    runs["worktree"] = scores_of(run_eval(
        repo, tasks, fixtures, args.limit,
        os.path.join(args.workdir, "results_worktree.json")))
    for rev in args.revs.split(","):
        rev = rev.strip()
        tag = rev.replace("/", "_").replace("~", "_")
        tree = os.path.join(args.workdir, "rev_" + tag)
        subprocess.run(["git", "worktree", "remove", "--force", tree],
                       cwd=repo, capture_output=True)
        r = subprocess.run(["git", "worktree", "add", "--detach", tree, rev],
                           cwd=repo, capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"git worktree add {rev} failed: {r.stderr}")
        try:
            print(f"[regression] rev {rev}: {tree}")
            runs[rev] = scores_of(run_eval(
                tree, tasks, fixtures, args.limit,
                os.path.join(args.workdir, f"results_{tag}.json")))
        finally:
            subprocess.run(["git", "worktree", "remove", "--force", tree],
                           cwd=repo, capture_output=True)

    lines, worst = diff_table(runs, args.threshold)
    print("\n" + "\n".join(lines))
    if worst > args.threshold:
        print(f"\n[regression] FAIL: max diff {worst:.3e} > "
              f"{args.threshold:.1e}")
        raise SystemExit(1)
    print(f"\n[regression] OK: max diff {worst:.3e} <= "
          f"{args.threshold:.1e}")
    return runs


if __name__ == "__main__":
    main()
