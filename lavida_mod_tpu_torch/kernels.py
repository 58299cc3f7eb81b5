"""Build and load the port's CUDA kernels.

Every `.cu` file under `csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`), one compiler process per source, all started together, and the
objects are linked into one shared library with a plain C interface, which
is loaded with `ctypes`.  The build runs at first use, into `build/` beside
this file (listed in `.gitignore`), and is keyed by a hash of the sources,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source is
rebuilt and an unchanged one is reused.  No PyTorch headers are compiled: a
build takes seconds, not minutes.  Before the library is loaded, the
compiler's report is held to the register counts that a kernel's design
depends on (`REGISTERS_AT_ENTRY`).

Wrappers launch on PyTorch's current stream and raise when the C entry
point returns a CUDA error (`check`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# no --use_fast_math: `/` stays the IEEE quotient and expf/rsqrtf keep
# their full-precision forms, which the plain versions compute too
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Kernels whose design needs ptxas to give each thread exactly this many
# registers at launch: the producer warpgroup of short_attention, of the
# three prefix_flash kernels, of w4_matmul_grouped's prefill kernel and of
# fused_vit_mlp's GEMM drops to 24 (`setmaxnreg.dec`) and their two consumer
# warpgroups rise to 240 (`setmaxnreg.inc`), and 128 x 24 + 256 x 240 =
# 384 x 168; w4_matmul's producer keeps 56 and its consumers take 224
# (128 x 56 + 256 x 224 = 384 x 168).  With fewer at entry the pool is short and `setmaxnreg.inc`
# waits for ever.
REGISTERS_AT_ENTRY = {"short_attention_kernel": 168,
                      "prefix_flash_fwd_kernel": 168,
                      "prefix_flash_dq_kernel": 168,
                      "prefix_flash_dkv_kernel": 168,
                      "w4_prefill_kernel": 168,
                      "mlp_gemm_kernel": 168,
                      "w4_matmul_kernel": 168}


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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
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
    nvcc = _nvcc()
    # compile to private names, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", lib, *objs], capture_output=True, text=True)
        log = "".join(f"== {src.name}\n{text}" for src, text in
                      zip(_sources(), logs)) + link.stdout + link.stderr
        out.with_suffix(".log").write_text(log)
        failed = [src.name for src, p in zip(_sources(), procs)
                  if p.returncode != 0]
        if failed or link.returncode != 0:
            raise RuntimeError(f"nvcc failed ({failed or 'link'}):\n"
                               f"{log[-4000:]}")
        os.replace(lib, out)
    return out


def check_registers(log: str) -> None:
    """Raise unless every instance of each kernel in `REGISTERS_AT_ENTRY`
    is reported by ptxas in `log` (the build's `-v` output) with exactly
    its register count, and at least one instance is."""
    entry = re.compile(r"Compiling entry function '([^']+)'")
    used = re.compile(r"Used (\d+) registers")
    found = {name: [] for name in REGISTERS_AT_ENTRY}
    current = None
    for line in log.splitlines():
        m = entry.search(line)
        if m:
            current = next((n for n in REGISTERS_AT_ENTRY if n in m.group(1)),
                           None)
            continue
        m = used.search(line)
        if m and current is not None:
            found[current].append(int(m.group(1)))
            current = None
    for name, want in REGISTERS_AT_ENTRY.items():
        if not found[name] or any(n != want for n in found[name]):
            raise RuntimeError(
                f"{name}: ptxas reports {found[name] or 'no instance'} "
                f"registers, the design needs {want} in every instance")


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, its register counts
    checked), with the argument types of every entry point declared."""
    path = build()
    check_registers(path.with_suffix(".log").read_text())
    lib = ctypes.CDLL(str(path))
    vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_float)
    lib.lavida_short_attention_bf16.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, vp]
    lib.lavida_short_attention_bf16.restype = ci
    lib.lavida_short_attention_f32.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, vp]
    lib.lavida_short_attention_f32.restype = ci
    lib.lavida_gather_rows.argtypes = [vp, vp, ci, vp, cl, cl, vp]
    lib.lavida_gather_rows.restype = ci
    lib.lavida_w8a8_matmul.argtypes = [vp] * 6 + [ci, ci, ci, vp]
    lib.lavida_act_quant.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.lavida_w4_qkv_norm.argtypes = [vp] * 7 + [ci] * 3 + [cf] + [ci] * 3 + [vp]
    lib.lavida_w4_qkv_norm_bias.argtypes = [vp] * 8 + [ci] * 3 + [cf] + [ci] * 3 + [vp]
    lib.lavida_w4_matmul_res.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.lavida_w4_ffn_fused.argtypes = [vp] * 13 + [ci] * 4 + [cf] + [ci] * 6 + [vp]
    lib.lavida_w4_grouped.argtypes = [vp] * 5 + [ci] * 9 + [vp]
    lib.lavida_w4_grouped_decode.argtypes = [vp] * 5 + [ci] * 9 + [vp]
    lib.lavida_kv8_decode_attention.argtypes = [vp] * 8 + [ci] * 6 + [cf] + [ci] * 6 + [vp]
    lib.lavida_kv4_decode_attention.argtypes = [vp] * 8 + [ci] * 6 + [cf] + [ci] * 6 + [vp]
    lib.lavida_vit_mlp.argtypes = [vp] * 10 + [ci] * 3 + [cf, vp]
    lib.lavida_prefix_flash_fwd.argtypes = [vp] * 7 + [ci] * 6 + [cf, vp]
    lib.lavida_prefix_flash_dq.argtypes = [vp] * 9 + [ci] * 6 + [cf, vp]
    lib.lavida_prefix_flash_dkv.argtypes = [vp] * 10 + [ci] * 6 + [cf, vp]
    lib.lavida_w4_matmul.argtypes = [vp] * 6 + [ci] * 10 + [vp]
    for fn in (lib.lavida_w8a8_matmul, lib.lavida_act_quant,
               lib.lavida_w4_qkv_norm, lib.lavida_w4_qkv_norm_bias,
               lib.lavida_w4_matmul_res,
               lib.lavida_w4_ffn_fused, lib.lavida_w4_grouped,
               lib.lavida_w4_grouped_decode,
               lib.lavida_kv8_decode_attention,
               lib.lavida_kv4_decode_attention, lib.lavida_vit_mlp,
               lib.lavida_prefix_flash_fwd, lib.lavida_prefix_flash_dq,
               lib.lavida_prefix_flash_dkv, lib.lavida_w4_matmul):
        fn.restype = ci
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
