#!/usr/bin/env python3
"""Time fused_vit_mlp's kernels (#9, csrc/vit_mlp.cu) built with design or
diagnostic edits, beside the kernels as they are, in turns in one process
on one CUDA card:

    python3 lavida_mod_tpu_torch/vit_mlp_variants.py
        [--variants base,notilesum,regstore,tmastore,fc1rows,nogelu,src=PATH]
        [--shapes 3645x1152x4304] [--copies 3]

Each variant is this tree's csrc/vit_mlp.cu (with the headers it includes)
compiled by its own nvcc, all in parallel, and called through
`lavida_vit_mlp`.  A variant is `base` or edits joined by "+":
  notilesum  fc2 sums all of F in one accumulator (no per-512 tile sum:
             one wait for the products per tile instead of one per 8
             slices), within the band but not the plain version's order;
  fc1rows    fc1's warpgroups split each tile by rows, as fc2's do,
             instead of ping-pong;
  regstore   fc2's threads store their pairs of columns, as fc1's do;
  tmastore   fc1 stores through shared memory and TMA, as fc2 does;
  noload     the producer fills the ring once, then releases each slot
             without copies: the consumers alone on stale slices;
  nomma      the consumers skip the products: the ring and the epilogues;
  noepi      the consumers skip the epilogues (no stores);
  nogelu     fc1's epilogue stores acc + b1 without the GELU;
  tanhapprox the GELU's tanhf as the hardware's tanh.approx.f32;
  stN        a ring of N stages of 32 KB (227 KB of shared memory in all
             with the TMA store's staging);
  src=PATH   another vit_mlp.cu with the same entry point, as it is (a
             design kept outside the tree).
A shape is MxDxF.  `--copies` cycles the calls through that many copies of
the weights, so that they are cold in the 50 MB L2 as a batch's 26 layers
find them.  Printed: each build's registers and spills per kernel, each
variant's error against the plain version, its device time per call
(kernel_times.cuda_ms) in two rounds, the second in reverse order, and the
time each of its three launches adds (kernel_times.kernel_split);
with `--sass DIR`, each variant's GEMM instructions (cuobjdump) in DIR.  A
variant that does not build is reported and left out.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
EDITS = {
    "notilesum": [("  const int group = kEpi == kFc2 ? kFTile / kBK : nk;",
                   "  const int group = nk;")],
    "fc1rows": [("constexpr bool kPingPong = kEpi == kFc1;", "constexpr bool kPingPong = false;")],
    "regstore": [("constexpr bool kTmaStore = kEpi == kFc2;", "constexpr bool kTmaStore = false;")],
    "tmastore": [("constexpr bool kTmaStore = kEpi == kFc2;", "constexpr bool kTmaStore = true;")],
    "noload": [("""        mbar_expect_tx(&full[slot], kStageBytes);
        tma_load_2d(st, &tm_a, &full[slot], k % nk * kBK, m0);
        tma_load_2d(st + kBM * kBK * 2, &tm_w, &full[slot], k % nk * kBK, n0);""",
                "        mbar_arrive(&full[slot]);")],
    "nomma": [("            wgmma_ss<128>(acc[h], da + 2 * ks, db + 2 * ks, (j | ks) != 0);",
               "            if (da == 1) wgmma_ss<128>(acc[h], da + 2 * ks, db + 2 * ks, (j | ks) != 0);")],
    "noepi": [("    for (int j = 0; j < 16; ++j) {", "    for (int j = 0; j < 0; ++j) {")],
    "nogelu": [("v0 = gelu_tanh(__fadd_rn(acc[h][e], b.x));",
                "v0 = __fadd_rn(acc[h][e], b.x);"),
               ("v1 = gelu_tanh(__fadd_rn(acc[h][e + 1], b.y));",
                "v1 = __fadd_rn(acc[h][e + 1], b.y);")],
    "tanhapprox": [("__device__ __forceinline__ float gelu_tanh(float v) {",
                    "__device__ __forceinline__ float tanh_approx(float x) {\n"
                    "  float y;\n  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
                    "  return y;\n}\n"
                    "__device__ __forceinline__ float gelu_tanh(float v) {"),
                   ("tanhf(inner)", "tanh_approx(inner)")],
}
EXACT = ("base", "fc1rows", "regstore", "tmastore")


def _edits(part):
    if re.fullmatch(r"st\d", part):
        return [("constexpr int kStages = 4;", f"constexpr int kStages = {part[2:]};")]
    return EDITS.get(part, [])


def _build(out_dir, edits, source=None):
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(os.path.join(HERE, "csrc"), out_dir)
    src = os.path.join(out_dir, "vit_mlp.cu")
    if source:
        shutil.copy(source, src)
    text = open(src).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{out_dir}: no {old!r} to edit")
        text = text.replace(old, new)
    open(src, "w").write(text)
    lib = os.path.join(out_dir, "lib.so")
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base,notilesum,regstore,nogelu")
    ap.add_argument("--shapes", default="3645x1152x4304")
    ap.add_argument("--copies", type=int, default=3)
    ap.add_argument("--sass", default=None,
                    help="a directory to write each variant's GEMM SASS into")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from lavida_mod_tpu_torch.kernel_times import cuda_ms, kernel_split
    from lavida_mod_tpu_torch.kernels import _nvcc
    from lavida_mod_tpu_torch.ops import vit_mlp as tv

    if not torch.cuda.is_available():
        raise RuntimeError("vit_mlp_variants.py needs a CUDA device")
    variants = args.variants.split(",")
    for v in variants:
        for part in v.split("+"):
            if part != "base" and part not in EDITS \
                    and not part.startswith("src=") \
                    and not re.fullmatch(r"st\d", part):
                raise ValueError(f"unknown variant {v!r}")
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {v: _build(os.path.join(tmp, str(i)), [
            e for part in v.split("+") for e in _edits(part)],
            v[4:] if v.startswith("src=") else None)
            for i, v in enumerate(variants)}
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for v, (lib, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(f"[variants] {v}: nvcc failed, left out:\n{log[-3000:]}")
                continue
            for name, spills, regs in re.findall(
                    r"Compiling entry function '([^']+)' for 'sm_90a'\n[\s\S]*?"
                    r"(\d+ bytes spill stores)[\s\S]*?(Used \d+ registers)", log):
                print(f"[variants] {v}: {_short(name)}: {regs}, {spills}")
            if args.sass:
                os.makedirs(args.sass, exist_ok=True)
                sass = subprocess.run([os.path.join(os.path.dirname(_nvcc()), "cuobjdump"),
                                       "-sass", lib], capture_output=True, text=True).stdout
                with open(os.path.join(args.sass, f"{v}.sass"), "w") as f:
                    f.write("\n".join(part for part in re.split(r"\n(?=\s*Function : )", sass)
                                      if "mlp_gemm_kernel" in part[:300]))
            so = ctypes.CDLL(lib)
            fn = so.lavida_vit_mlp
            fn.argtypes = [vp] * 10 + [ci] * 3 + [cf, vp]
            fn.restype = ci
            fn.so = so
            fns[v] = fn
        run_shapes(torch, tv, cuda_ms, kernel_split, fns, args)


def run_shapes(torch, tv, cuda_ms, kernel_split, fns, args):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    name = torch.cuda.get_device_name(0)
    bf = {"dtype": torch.bfloat16, "device": dev}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).bfloat16()

    for shape in args.shapes.split(","):
        M, D, F = map(int, shape.split("x"))
        x = randn(M, D)
        ws = [((1 + randn(D, scale=0.1)).bfloat16(), randn(D, scale=0.1),
               randn(F, D, scale=0.03), randn(F, scale=0.1),
               randn(D, F, scale=0.03), randn(D, scale=0.1))
              for _ in range(args.copies)]
        ref = tv.fused_vit_mlp_reference(x, *ws[0])
        calls = {}
        for v, fn in fns.items():
            ln, h = torch.empty(M, D, **bf), torch.empty(M, F, **bf)
            out = torch.empty(M, D, **bf)

            def call(fn=fn, ln=ln, h=h, out=out, it=iter(range(1 << 62)), v=v):
                w = ws[next(it) % len(ws)]
                err = fn(x.data_ptr(), *(t.data_ptr() for t in w), ln.data_ptr(),
                         h.data_ptr(), out.data_ptr(), M, D, F, 1e-6,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{v}: cudaError_t {err}")
                return out

            o = call(it=iter(range(1 << 62)))   # ws[0]
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            tag = "" if all(part in EXACT or part.startswith("src=") or
                            re.fullmatch(r"st\d", part)
                            for part in v.split("+")) else " (edited)"
            print(f"[variants] {v} M {M} D {D} F {F}: max error {err:.3e} "
                  f"against the plain version (limit 5e-2){tag}")
            calls[v] = call
        times = {v: [] for v in calls}
        for order in (list(calls), list(reversed(calls))):
            for v in order:
                times[v].append(cuda_ms(calls[v]))
        for v, call in calls.items():
            split = kernel_split(torch, call)
            parts = ", ".join(f"{_short(k)} adds {a:.4f}"
                              for k, (a, _) in sorted(split.items(),
                                                      key=lambda kv: -kv[1][0]))
            print(f"[variants] {v} M {M} D {D} F {F}: "
                  f"{' / '.join(f'{t:.4f}' for t in times[v])} ms per call "
                  f"({args.copies} weight copies); split: {parts} ({name})")


def _short(kernel: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    m = re.search(r"[a-z_]+_kernel(<[^>]*>|I\w{2,3}E)?", kernel)
    return m[0] if m else kernel[:40]


if __name__ == "__main__":
    main(sys.argv[1:])
