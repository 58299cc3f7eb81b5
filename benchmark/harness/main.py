"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its per-layer metrics
are found by name: `BENCHMARK.json` at the checkout's root names the
cell's configuration file and mix; `benchmark/traffic/<mix>.json` names
its runner (`kind`: `benchmark/harness/<kind>.py`); each per-layer metric
is read by `benchmark/metrics/<metric>.py::read`.  A new cell, mix or
metric is new files and manifest entries.

The last line of standard output is the result (JSON); the last lines of
standard error are the numbers the check compared, each beside its limit.
`setup_s` counts the kernel library's nvcc build on a checkout's first run
(the contract's set-up of a run that compiles); the result's
`setup_build_s` gives that part apart, and the load alone on later runs.
A run that finds no card, or fewer cards than the cell asks for, or that
finds JAX or the JAX package loaded once the window has closed, exits
with a code other than 0 and prints no result."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lavida_mod_tpu")


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str, bench: Path = BENCH):
    path = bench / "metrics" / f"{name}.py"
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Cell:
    """One run's settings and the clock and memory hooks the runners
    share."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float,
                 trace: bool, device, t_start: float):
        import torch

        from harness.trace import Recorder
        from harness.weights import leaf_shapes
        from reference.lavida import lm_geometry

        man = manifest(root)
        self.workload = find(man["workloads"], workload, "workload")
        cfg_entry = find(man["configs"], self.workload["config"],
                         "configuration")
        with open(root / cfg_entry["file"]) as f:
            self.conf = json.load(f)
        self.bench = root / "benchmark"
        with open(self.bench / "traffic" / f"{self.workload['traffic']}.json") as f:
            self.mix = json.load(f)
        self.name, self.seed, self.seconds = workload, int(seed), seconds
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.geo = lm_geometry(self.conf["family"], self.conf)
        comp = self.conf["composition"]
        self.vcfg = dict(self.conf["vision"],
                         grid_pinpoints=[tuple(p) for p in
                                         comp["image_grid_pinpoints"]])
        self.shapes = leaf_shapes(self.geo, self.vcfg)
        self.recorder = Recorder(self.trace)
        self._setup_peak = 0
        self.build_s = 0.0      # the kernel library's build and load

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> float:
        self.sync()
        return time.perf_counter() - self.t_start

    def reset_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self._setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        """The window's peak allocation (bytes); the run's peak so far is
        kept for `memory_peak_bytes`."""
        import torch

        if self.device.type != "cuda":
            return 0
        p = torch.cuda.max_memory_allocated(self.device)
        self._setup_peak = max(self._setup_peak, p)
        return p

    @property
    def run_peak(self) -> int:
        return self._setup_peak


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None
             ) -> tuple[dict, list[str]]:
    """Run one cell; returns (result, check lines)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(root, workload, seed, seconds, trace, device, t_start)
    runner = importlib.import_module(f"harness.{cell.mix['kind']}")
    out = runner.run(cell)
    man = manifest(root)
    limits = json.loads((cell.bench / "limits" / f"{workload}.json")
                        .read_text())
    check = {k: (v, limits[k]) for k, v in out["check"].items()}
    correct = all(v == v and v <= lim for v, lim in check.values())
    metrics, breakdown, dev = {}, None, {}
    if not trace:
        for m in man["end_to_end"]:
            if applies(m, workload) and m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        tr = cell.recorder.read(out["phases"]) if cell.recorder.prof \
            else None
        ctx = dict(out.get("layer_ctx", {}), trace=tr,
                   window_s=out["window_s"], conf=cell.conf, mix=cell.mix,
                   geo=cell.geo, vcfg=cell.vcfg)
        for m in man["per_layer"]:
            if not applies(m, workload):
                continue
            v = load_reader(m["name"], cell.bench)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            dev = {"busy_s": tr["busy_s"], "window_s": tr["span_s"]}
            ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1][0])
            breakdown = {"device_ops": [[n, s] for n, (s, _) in ops[:10]],
                         "idle_gaps": [[n, s] for n, s in tr["gaps"][:10]]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(cell, dev)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_build_s"] = cell.build_s
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in check.items()}
    lines = [f"check {k}: {v!r} (limit {lim!r})"
             for k, (v, lim) in check.items()]
    return result, lines


def device_info(cell: Cell, extra: dict) -> dict:
    import torch

    if cell.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0, **extra}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(cell.device),
            "count": 1, "memory_peak_bytes": cell.run_peak,
            "power_limit": power_limit(), **extra}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    chips = find(manifest()["workloads"], a.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card, or fewer than the {chips} this cell asks for",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result, lines = run_cell(ROOT, a.workload, a.seed, a.seconds,
                             bool(a.trace), "cuda", t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
