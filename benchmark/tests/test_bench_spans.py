"""The readers of the program's spans: the idle arithmetic of
`metrics/_spans.py` on synthetic kernels and spans, and the tiny serve
cell traced on the CPU, where only the host-stamp reader has something to
read."""

import sys

import pytest

import tiny
from harness.main import BENCH, run_cell
from harness.trace import union_busy

sys.path.insert(0, str(BENCH / "metrics"))
import _spans  # noqa: E402


def sp(sid, name, parent, a, b, root=1):
    """A span with stamps a..b in us."""
    return {"name": name, "id": sid, "parent": parent, "root": root,
            "row": None, "start_ns": a * 1000, "end_ns": b * 1000,
            "device_ms": None}


SPANS = [sp(1, "serve.batch", None, 0, 100), sp(2, "vision.encode", 1, 5, 30),
         sp(3, "vision.upload", 2, 5, 12), sp(4, "lm.step", 1, 40, 70),
         sp(5, "lm.forward", 4, 40, 60), sp(6, "lm.commit", 4, 60, 70)]
KERNELS = [("k", 14, 20), ("k", 18, 28), ("k", 45, 58), ("k", 62, 66),
           ("k", 66, 69), ("k", 90, 120)]


def test_idle_goes_to_the_innermost_span():
    idle = _spans.idle_by_span(KERNELS, SPANS, 0, 100)
    us = {k: round(v * 1e6, 6) for k, v in idle.items()}
    # [0, 14): midpoint 7 in vision.upload; [28, 45): 36.5 in serve.batch;
    # [58, 62): 60 at lm.commit's opening; [69, 90): 79.5 in serve.batch
    assert us == {3: 14.0, 1: 17.0 + 21.0, 6: 4.0}
    inside = [(max(a, 0), min(b, 100)) for _, a, b in KERNELS]
    assert abs(sum(idle.values()) - (100e-6 - union_busy(inside))) < 1e-12


def test_idle_outside_every_span_is_none():
    spans = [sp(1, "serve.batch", None, 10, 20), sp(2, "serve.batch", None,
                                                    30, 40, root=2)]
    idle = _spans.idle_by_span([("k", 12, 18), ("k", 32, 38)], spans, 10, 40)
    us = {k: round(v * 1e6, 6) for k, v in idle.items()}
    # [10, 12) in the first batch, [18, 32) between the two, [38, 40)
    assert us == {1: 2.0, None: 14.0, 2: 2.0}


def test_idle_under_a_name_counts_descendants():
    ctx = {"trace": {"kernels": KERNELS}}
    total, n = _spans.idle_under(ctx, SPANS, "lm.step")
    assert n == 1 and abs(total - 4e-6) < 1e-12
    total, n = _spans.idle_under(ctx, SPANS, "vision.encode")
    assert n == 1 and abs(total - 14e-6) < 1e-12
    assert _spans.idle_under({"trace": {"kernels": []}}, SPANS,
                             "lm.step") is None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("tiny"))
    res, _ = run_cell(root, "tiny-serve", 31, 0.2, True, "cpu")
    return res


def test_cpu_serve_cell_reads_host_stamps_only(traced):
    got = traced["metrics"]
    assert traced["correct"]
    assert got["step_host_ms.serve"]["value"] > 0
    for name in ("prefill_ms.serve", "step_ms.serve", "step_idle_ms.serve",
                 "encode_idle_ms.serve"):
        assert name not in got, name
