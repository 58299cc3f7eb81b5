"""A later change adds a cell, a traffic mix and a per-layer metric as
new files and manifest entries: the harness finds and runs them with no
edit to a file that was there."""

import hashlib
import json
from pathlib import Path

import tiny
from harness.main import run_cell


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_by_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _digests(root / "benchmark")
    bench = root / "benchmark"
    mix = dict(tiny.SERVE, batch=3, image_sizes=[[60, 100]])
    (bench / "traffic" / "tiny-serve-b3.json").write_text(json.dumps(mix))
    (bench / "metrics" / "batches.serve.py").write_text(
        "def read(ctx):\n    return float(ctx['items'])\n")
    (bench / "limits" / "tiny-serve-b3.json").write_text('{"gap": 0.5}')
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "tiny-serve-b3", "config": "tiny-llada",
                             "traffic": "tiny-serve-b3", "chips": 1,
                             "why": "added by files"})
    man["per_layer"].append({"name": "batches.serve", "unit": "1",
                             "better": "higher", "source": "program_counter",
                             "layer": "LM and generation",
                             "moves": "images_per_s",
                             "workloads": ["tiny-serve-b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items())

    res, lines = run_cell(root, "tiny-serve-b3", 11, 0.2, True, "cpu")
    assert res["attempted"] % 3 == 0 and res["correct"]
    assert res["metrics"]["batches.serve"]["value"] >= 1
    assert lines and lines[-1].startswith("check gap")
