"""The in-training eval hook (lavida_mod_tpu_torch.train.eval_hook) and the
two training CLIs that call it, against the JAX package on the CPU:

  - `run_in_training_eval` on a tiny f32 model (the port on JAX's weights)
    and a written jsonl gives the keys of JAX's and its values, exactly,
    but for the wall and latency entries; it shares the model's
    parameters (no copy) and leaves them and their gradients untouched;
  - `python -m lavida_mod_tpu_torch.train --tiny --eval-tasks pope
    --eval-every 1 --eval-data-path pope=<jsonl>` logs the eval rows in
    metrics.jsonl at every optimizer step and ends with the training
    state bit-equal to the same run without the eval;
  - the SHIRG-LoRA harness with --eval-every and --eval-tasks calls the
    hook as scripts/train_shirg_lora.py does (no tokenizer, no data
    paths): the documents come from `datasets`, which the card machine
    lacks, and both packages raise the same ModuleNotFoundError there;
    an unknown task raises KeyError in both.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu.train import eval_hook as jhook
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.tools import eval_smoke_all as smoke
from lavida_mod_tpu_torch.tools.make_synthetic_data import make
from lavida_mod_tpu_torch.train import eval_hook as thook

torch.set_num_threads(2)

CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
TIMING = ("wall_s", "avg_latency_s")


class WordTokenizer:
    bos_token_id = 1
    chat_template = None
    WORDS = ["yes", "no", "Yes", "the", "dog", "a"]

    def __call__(self, text):
        class R:
            input_ids = [1] + [10 + (ord(c) % 80) for c in text[:24]]

        return R()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.WORDS[int(i) % len(self.WORDS)] for i in ids)


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    d = tmp_path_factory.mktemp("docs")
    imgs = smoke.write_images(str(d))
    return {n: smoke.write_docs(n, str(d), imgs) for n in ("pope", "mme")}


@pytest.fixture(scope="module")
def pair():
    jm = JLaViDa.random_init(CFG, 0, jnp.float32)
    jm.params["llada"] = jl.unstack_blocks(jax.tree.map(
        lambda a: a * 10.0 if a.ndim >= 2 else a, jm.params["llada"]))
    tm = LaViDa.from_jax(CFG, jax.tree.map(np.asarray, jm.params), "cpu")
    return jm, tm


def _split(flat):
    timed = {k for k in flat if k.rsplit("/", 1)[1] in TIMING}
    return {k: v for k, v in flat.items() if k not in timed}, timed


def test_run_in_training_eval_equals_jax(pair, docs):
    jm, tm = pair
    tasks = ["pope", "mme"]
    want = jhook.run_in_training_eval(CFG, jm.params, WordTokenizer(), tasks,
                                      docs, limit=3)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    got = thook.run_in_training_eval(CFG, tm, WordTokenizer(), tasks, docs,
                                     limit=3)
    assert list(got) == list(want)
    (gv, gt), (wv, wt) = _split(got), _split(want)
    assert gv == wv and gt == wt and len(gt) == 4
    assert got["eval/pope/n_docs"] == 3.0
    assert all(isinstance(v, float) for v in got.values())
    for n, p in tm.named_parameters():
        assert p.grad is None and torch.equal(p.detach(), before[n]), n


def test_eval_view_shares_the_parameters(pair):
    _, tm = pair
    view = thook.eval_view(tm, CFG, "dream")
    assert view.lm_family == "dream" and tm.lm_family == "llada"
    assert all(a is b for a, b in zip(view.parameters(), tm.parameters()))


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("syn")
    return make(str(d), n=8, size=96), str(d / "images")


def _state(state):
    from lavida_mod_tpu_torch.train.cli import train_payload

    params, opt = train_payload(state)
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + str(k)] = v
    walk({"params": params, "opt_state": opt}, "")
    return out


def test_train_cli_eval_logs_rows_and_leaves_the_state(data, docs, tmp_path):
    from lavida_mod_tpu_torch.train import cli

    path, images = data
    base = ["--tiny", "--device", "cpu", "--data-path", path,
            "--image-folder", images, "--batch-size", "2", "--lr", "1e-3",
            "--steps", "2", "--grad-accum", "2", "--log-every", "1",
            "--prefetch", "0"]
    plain = cli.main(base + ["--output-dir", str(tmp_path / "a")])
    ev = cli.main(base + ["--output-dir", str(tmp_path / "b"),
                          "--eval-tasks", "pope,mme", "--eval-every", "1",
                          "--eval-limit", "2", "--eval-data-path",
                          f"pope={docs['pope']},mme={docs['mme']}"])
    assert ev["losses"] == plain["losses"]
    a, b = _state(plain["state"]), _state(ev["state"])
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert plain["evals"] == [] and [r["step"] for r in ev["evals"]] == [1, 2]
    rows = [json.loads(line) for line in open(tmp_path / "b" /
                                               "metrics.jsonl")]
    evals = [r for r in rows if any(k.startswith("eval/") for k in r)]
    assert [r["step"] for r in evals] == [1, 2]
    for r in evals:
        keys = {k for k in r if k.startswith("eval/")}
        assert {"eval/pope/accuracy", "eval/pope/f1", "eval/pope/n_docs",
                "eval/mme/n_docs"} <= keys
        assert r["eval/pope/n_docs"] == 2.0
        assert all(np.isfinite(r[k]) for k in keys)
    assert len(rows) == len(evals) + 2


# ---------------------------------------------------------------------------
# the SHIRG-LoRA harness
# ---------------------------------------------------------------------------

def test_shirg_harness_eval_as_jax(data, tmp_path, monkeypatch, pair):
    from lavida_mod_tpu_torch import train_shirg_lora as h

    path, images = data
    monkeypatch.setitem(sys.modules, "datasets", None)
    argv = ["--tiny", "--device", "cpu", "--data-path", path,
            "--image-folder", images, "--output-dir", str(tmp_path / "run"),
            "--steps", "2", "--warmup-steps", "1", "--save-every", "5"]
    jm, _ = pair
    for tasks, err in (("pope", ModuleNotFoundError), ("mmmu", KeyError)):
        with pytest.raises(err) as want:
            jhook.run_in_training_eval(CFG, jm.params, None,
                                       tasks.split(","), None, limit=16)
        with pytest.raises(err) as got:
            h.main(argv + ["--eval-every", "1", "--eval-tasks", tasks])
        assert str(got.value) == str(want.value)
    # without --eval-every the harness never calls the hook
    run = h.main(argv + ["--eval-tasks", "pope"])
    assert len(run["losses"]) == 2
