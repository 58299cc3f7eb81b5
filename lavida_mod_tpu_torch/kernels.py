"""Build and load the port's CUDA kernels.

Every `.cu` file under `csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into one shared library with a plain C interface, which is
loaded with `ctypes`.  The build runs at first use, into `build/` beside
this file (listed in `.gitignore`), and is keyed by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
No PyTorch headers are compiled: a build takes seconds, not minutes.

Wrappers launch on PyTorch's current stream and raise when the C entry
point returns a CUDA error (`check`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblavida_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path.  The
    compiler's output (ptxas registers, shared memory and spills per
    kernel) is kept beside it as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the argument
    types of every entry point declared."""
    lib = ctypes.CDLL(str(build()))
    vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_float)
    lib.lavida_short_attention_bf16.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, vp]
    lib.lavida_short_attention_bf16.restype = ci
    lib.lavida_gather_rows.argtypes = [vp, vp, ci, vp, cl, cl, vp]
    lib.lavida_gather_rows.restype = ci
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
