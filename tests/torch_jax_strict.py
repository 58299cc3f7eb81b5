"""Run JAX reference code in a child process with XLA's excess precision off.

XLA on the CPU removes a round trip f32 -> bf16 -> f32 when it can
(`--xla_allow_excess_precision`, on by default), so a JAX function that
rounds an intermediate to bf16 and computes on is evaluated without that
rounding.  The port rounds where the code says so, as the CUDA kernels do.
With the flag off the two agree bit for bit; the flag is read once per
process, so the references are computed in a child process, never in the
test process (tests/conftest.py has set up JAX there already).

`strict_jax(code, tmp_path, inputs)` runs `code` in `python -c` with JAX on
the CPU; the code reads the numpy arrays of `inputs` from the dict `IN`,
fills a dict `OUT` with numpy arrays, and `strict_jax` returns it.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]

_PRELUDE = """
import numpy as np
with np.load(__in_path__) as _z:
    IN = {k: _z[k] for k in _z.files}
OUT = {}
"""

_EPILOGUE = """
np.savez(__out_path__, **OUT)
"""


def strict_jax(code: str, tmp_path: pathlib.Path, inputs: dict | None = None,
               timeout: int = 600) -> dict:
    src, out = tmp_path / "strict_in.npz", tmp_path / "strict_out.npz"
    np.savez(src, **(inputs or {}))
    script = (_PRELUDE + textwrap.dedent(code) + _EPILOGUE).replace(
        "__out_path__", repr(str(out))).replace("__in_path__", repr(str(src)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}
