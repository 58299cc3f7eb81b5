"""The comparison that decides `correct`, driven through whole runs at a
tiny size on the CPU (the harness's look for a card skipped): sound runs
come out correct, the control (the reference in the nearest lower
precision, in the program's place) comes out not correct, and so does
each fault a cell can have, planted under the timed path."""

import pytest

import readings
import tiny
from harness import serve_batch, train_step
from harness.main import run_cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell, seed, fault=None):
    with readings.fault(fault):
        res, lines = run_cell(root, cell, seed, 0.2, False, "cpu")
    return res


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train",
                                  "tiny-dream-train"])
def test_sound_runs_are_correct(root, cell):
    for seed in (21, 22):
        res = run(root, cell, seed)
        assert res["correct"], res["check"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_serve_control_is_not_correct(root, seed, monkeypatch):
    got = {}
    orig = serve_batch.check

    def check(cell, pairs, control=False):
        got.update(orig(cell, pairs, control=True))
        return {"gap": got["control_gap"]}

    monkeypatch.setattr(serve_batch, "check", check)
    res = run(root, "tiny-serve", seed)
    assert not res["correct"], got


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-dream-train"])
def test_train_control_is_not_correct(root, cell, monkeypatch):
    orig_ref, orig_cmp = train_step.reference, train_step.compare
    control = {}

    def reference(cell_, pool, mode="f32"):
        control["fp8"] = orig_ref(cell_, pool, "fp8")
        return orig_ref(cell_, pool)

    monkeypatch.setattr(train_step, "reference", reference)
    monkeypatch.setattr(train_step, "compare", lambda prog, want:
                        orig_cmp(control["fp8"], want))
    for seed in (11, 12):
        res = run(root, cell, seed)
        assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-serve", "token"), ("tiny-train", "frozen"), ("tiny-train", "half"),
    ("tiny-dream-train", "frozen"), ("tiny-dream-train", "half")])
def test_faults_are_not_correct(root, cell, fault):
    for seed in (11, 12):
        res = run(root, cell, seed, fault)
        assert not res["correct"], (fault, res["check"])
