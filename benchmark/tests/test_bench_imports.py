"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "lavida_mod_tpu"}


def test_fresh_interpreter_loads_no_jax():
    code = f"""
import importlib, json, runpy, sys
from pathlib import Path
sys.argv = ["run.py"]
runpy.run_path({str(BENCH / 'run.py')!r}, run_name="not_main")
bench = Path({str(BENCH)!r})
for sub in ("harness", "work", "reference"):
    for f in sorted((bench / sub).glob("*.py")):
        if f.stem != "__init__":
            importlib.import_module(f"{{sub}}.{{f.stem}}")
from harness.main import load_reader
for f in sorted((bench / "metrics").glob("*.py")):
    if not f.stem.startswith("_"):
        load_reader(f.stem, bench)
# what the runners import of the program
import lavida_mod_tpu_torch.eval.adapter, lavida_mod_tpu_torch.train.step
import lavida_mod_tpu_torch.models.lavida, lavida_mod_tpu_torch.ops.sampling
import harness.program as p
p.counters()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "lavida_mod_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_either_package():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & (FORBIDDEN | {"lavida_mod_tpu_torch", "harness"})
        assert not bad, (f.name, bad)


def test_harness_sources_import_no_jax():
    for f in BENCH.rglob("*.py"):
        assert not _imports(f) & FORBIDDEN, f
