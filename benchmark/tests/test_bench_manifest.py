"""BENCHMARK.json against the benchmark's rules: keys, names, units,
lengths, and every file a name leads to."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(MAN["command"]) <= 32
    assert (ROOT / MAN["command"][1]).is_file()
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_cells_and_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert len(pairs) == len(MAN["workloads"]) and used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_metrics():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        moved = next(x for x in MAN["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for w in cells:        # every cell: setup_s, another e2e, a per-layer one
        e = [m for m in MAN["end_to_end"] if w in m.get("workloads", cells)]
        assert len(e) >= 2 and any(
            w in m.get("workloads", cells) for m in MAN["per_layer"])
