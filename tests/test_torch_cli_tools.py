"""The port's predict generation flags and its eval regression tool.

  - `lavida_mod_tpu_torch.predict` takes every generation flag of the
    repo's predict.py (--steps, --step-per-block, --step-ratio,
    --block-length, --schedule, --schedule-shift, --remasking, --aspect)
    with its defaults, and builds the GenerationConfig predict.py builds:
    the JAX CLI's own add_argument calls and its `GenerationConfig(...)`
    expression are read from predict.py's syntax tree and run on the same
    argv, and the two configs are held equal field by field;
  - --aspect sets the vision config's image_aspect_ratio (square: one view
    per request) and the CLI runs with the flags on the CPU;
  - `tools/eval_regression.py` runs the port's --tiny CPU eval on the
    working tree of a temporary git repository holding the port and on
    its HEAD, and diffs the scores: exact where the code is the same, and
    the changed scorer's metric flagged (exit 1) where the working tree
    changed it.
"""

import argparse
import ast
import pathlib
import shutil
import subprocess

import pytest

from lavida_mod_tpu.config import GenerationConfig as JGenerationConfig
from lavida_mod_tpu_torch import predict as tp
from lavida_mod_tpu_torch.config import as_port_config

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ("--steps", "--step-per-block", "--step-ratio", "--block-length",
         "--schedule", "--schedule-shift", "--remasking", "--aspect",
         "--max-new-tokens", "--no-prefix-cache")


def _jax_cli():
    """(parser, gen_expr) of predict.py: every ap.add_argument call of its
    main on a fresh parser, and its GenerationConfig(...) call."""
    tree = ast.parse((REPO / "predict.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    ap = argparse.ArgumentParser()
    gen = None
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr == "add_argument":
                eval(compile(ast.Expression(node), "predict.py", "eval"),
                     {"ap": ap})
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and getattr(node.value.func, "id", None) == "GenerationConfig":
            gen = compile(ast.Expression(node.value), "predict.py", "eval")
    return ap, gen


ARGVS = [
    [],
    ["--max-new-tokens", "64", "--steps", "32"],
    ["--max-new-tokens", "256", "--step-per-block", "16",
     "--block-length", "64", "--remasking", "random"],
    ["--step-ratio", "0.5", "--schedule", "shift", "--schedule-shift",
     "0.33", "--no-prefix-cache"],
    ["--schedule", "cosine", "--remasking", "margin", "--aspect", "pad",
     "--max-new-tokens", "200"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_generation_flags_build_jax_config(argv):
    jap, gen_expr = _jax_cli()
    jargs, targs = jap.parse_args(argv), tp.parser().parse_args(argv)
    for flag in FLAGS:
        dest = flag[2:].replace("-", "_")
        assert getattr(targs, dest) == getattr(jargs, dest), flag
    want = eval(gen_expr, {"GenerationConfig": JGenerationConfig,
                           "args": jargs})
    assert as_port_config(want) == tp.generation_config(targs)


def test_flag_defaults_equal_jax():
    jap, _ = _jax_cli()
    tap = tp.parser()
    for flag in FLAGS:
        ja = next(a for a in jap._actions if flag in a.option_strings)
        ta = next(a for a in tap._actions if flag in a.option_strings)
        assert (ta.default, ta.type) == (ja.default, ja.type), flag


def test_aspect_sets_the_vision_config(capsys):
    cfg = tp.tiny_config("square")
    assert cfg.vision.image_aspect_ratio == "square"
    assert tp.with_aspect(cfg, None) is cfg
    assert tp.with_aspect(cfg, "pad").vision.image_aspect_ratio == "pad"
    tp.main(["--tiny", "--device", "cpu", "--aspect", "square", "--steps",
             "8", "--max-new-tokens", "16", "--block-length", "8",
             "--schedule", "shift", "--schedule-shift", "0.33"])
    out = capsys.readouterr().out
    assert "1 views; len=16" in out and "output ids" in out


def test_eval_regression_diffs_two_revisions(tmp_path, monkeypatch):
    """Two revisions of a temporary git repo holding the port: its HEAD
    and a working tree whose POPE scorer compares against "yes" always.
    The tool calibrates on the working tree, runs both through the
    port's --tiny CPU eval and exits 1 on POPE's changed accuracy, while
    GSM8K's exact match agrees exactly."""
    from lavida_mod_tpu_torch.tools import eval_regression as er

    # the tool's eval processes inherit the environment: two threads each
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    repo = tmp_path / "repo"
    shutil.copytree(REPO / "lavida_mod_tpu_torch", repo / "lavida_mod_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (repo / "csrc").mkdir()
    for f in ("bpe.cpp", "image_prep.cpp", "Makefile"):
        shutil.copy(REPO / "csrc" / f, repo / "csrc" / f)
    git = ["git", "-c", "user.email=t@t", "-c", "user.name=t"]
    subprocess.run(["git", "init", "-q"], cwd=repo, check=True)
    subprocess.run(["git", "add", "-A"], cwd=repo, check=True)
    subprocess.run(git + ["commit", "-qm", "a"], cwd=repo, check=True)
    tasks = repo / "lavida_mod_tpu_torch" / "eval" / "tasks.py"
    src = tasks.read_text()
    old = '"gt": str(doc["target"]).lower().strip(),'
    assert src.count(old) == 1
    tasks.write_text(src.replace(old, '"gt": "yes",'))
    with pytest.raises(SystemExit) as e:
        er.main(["--repo", str(repo), "--workdir", str(tmp_path / "w"),
                 "--revs", "HEAD", "--tasks", "pope,gsm8k", "--limit", "2"])
    assert e.value.code == 1
    runs = {}
    for name in ("worktree", "HEAD"):
        with open(tmp_path / "w" / f"results_{name}.json") as f:
            import json
            runs[name] = er.scores_of(json.load(f))
    assert runs["worktree"]["gsm8k/exact_match"] == \
        runs["HEAD"]["gsm8k/exact_match"]
    assert runs["worktree"]["pope/accuracy"] != runs["HEAD"]["pope/accuracy"]
    lines, worst = er.diff_table(runs, 1e-9)
    assert worst > 0 and any("pope/accuracy" in ln and "**" in ln
                             for ln in lines)
    listed = subprocess.run(["git", "worktree", "list"], cwd=repo,
                            capture_output=True, text=True).stdout
    assert len(listed.strip().splitlines()) == 1     # the revision removed
