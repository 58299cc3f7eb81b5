#!/usr/bin/env python3
"""Time w4_matmul_grouped's decode kernel (#4 at T <= 256,
csrc/w4_grouped.cu) built with diagnostic edits or another row split,
beside the kernel as it is, in turns in one process on one CUDA card:

    python3 lavida_mod_tpu_torch/w4_decode_variants.py
        [--variants base,nocodes,noweights,nomma,noflush,nocompute,rb64]
        [--shapes 128x4096x4096,128x4096x12288] [--copies 8]

Each variant is this tree's csrc/w4_grouped.cu (with the headers it
includes) compiled by its own nvcc, all in parallel, and called through
its `lavida_w4_grouped_decode` on the codes and row scales that the
port's row quantization makes of the same x.  A variant is `base` (the
kernel as it is), `rbN` (the plan of ops/w4_grouped.py::decode_plan with
N rows per unit forced) or one diagnostic edit, whose outputs are then
wrong unless marked exact:
  nocodes    the producer copies the codes of the ring's first stages
             only: the weights, the products and the flush alone;
  noweights  the producer skips the weight copies;
  nomma      the consumers skip the wgmma products;
  noflush    the consumers skip the per-group f32 flush;
  ssmma      the products read A from shared memory (wgmma SS, the
             unit's codes standing in for the weights; rb 64 only);
  nocompute  the consumers skip every group's work (loads of the A
             fragments, products, flush): the ring alone;
  timeline   exact, with clock64 sums of one consumer warp per CTA: the
             cycles per stage it waits for copies, waits for products,
             flushes and issues, printed after its timing.
A shape is TxKxN.  `--copies` cycles the calls through that many copies
of the weights, so that they are cold in the 50 MB L2 as a batch's 32
layers find them.  Printed: each build's registers, each variant's plan
and error against the plain version, and its device time per call
(kernel_times.cuda_ms) in two rounds, the second in reverse order.
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
DIAGNOSTICS = {
    "nocodes": [
        ("kDecSG * kDecCols * 4 + ng * RB * kGroup);",
         "kDecSG * kDecCols * 4 + (q.pass == 0 ? ng : 0) * RB * kGroup);"),
        ("for (int gi = 0; gi < ng; ++gi)\n          hopper::tma_load_2d(",
         "for (int gi = 0; gi < (q.pass == 0 ? ng : 0); ++gi)\n          hopper::tma_load_2d(")],
    "noweights": [
        ("hopper::mbar_expect_tx(bar, kDecWBytes + kDecSG",
         "hopper::mbar_expect_tx(bar, kDecSG"),
        ("hopper::tma_load_3d(st, &tm_w", "if (0) hopper::tma_load_3d(st, &tm_w")],
    "nomma": [("for (int s = 0; s < 4; ++s) wgmma_rs(acc[b], a[b][s], db + 2 * s, s);",
               "if (db == 1) wgmma_rs(acc[b], a[b][0], db, 0);")],
    "noflush": [("part[i] = __fadd_rn(part[i], __fmul_rn(d, sc[b][(i >> 1) & 1]));",
                 "if (d == 1.0f) part[i] = sc[b][0];")],
    # the products from shared memory alone (wgmma SS, A = the unit's first
    # 64 rows of codes): what the tensor cores take without register A
    "ssmma": [
        ("__device__ __forceinline__ uint4 lds128(uint32_t addr) {",
         "__device__ __forceinline__ void wgmma_ss64(int (&d)[32], uint64_t da, uint64_t db) {\n"
         "  asm volatile(\"{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n\"\n"
         "      \"wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, "
         "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
         "%26, %27, %28, %29, %30, %31}, %32, %33, p;\\n}\\n\"\n"
         "      : \"+r\"(d[0]), \"+r\"(d[1]), \"+r\"(d[2]), \"+r\"(d[3]), \"+r\"(d[4]), \"+r\"(d[5]), "
         "\"+r\"(d[6]), \"+r\"(d[7]), \"+r\"(d[8]), \"+r\"(d[9]), \"+r\"(d[10]), \"+r\"(d[11]), "
         "\"+r\"(d[12]), \"+r\"(d[13]), \"+r\"(d[14]), \"+r\"(d[15]), \"+r\"(d[16]), \"+r\"(d[17]), "
         "\"+r\"(d[18]), \"+r\"(d[19]), \"+r\"(d[20]), \"+r\"(d[21]), \"+r\"(d[22]), \"+r\"(d[23]), "
         "\"+r\"(d[24]), \"+r\"(d[25]), \"+r\"(d[26]), \"+r\"(d[27]), \"+r\"(d[28]), \"+r\"(d[29]), "
         "\"+r\"(d[30]), \"+r\"(d[31])\n"
         "      : \"l\"(da), \"l\"(db), \"r\"(1));\n}\n"
         "template <int n> __device__ __forceinline__ void wgmma_ss64(int (&d)[n], uint64_t, uint64_t) {}\n"
         "__device__ __forceinline__ uint4 lds128(uint32_t addr) {"),
        ("for (int s = 0; s < 4; ++s) wgmma_rs(acc[b], a[b][s], db + 2 * s, s);",
         "for (int s = 0; s < 4; ++s) wgmma_ss64(acc[b], db + 2 * s, db + 2 * s);")],
    "nocompute": [
        ("  auto issue = [&](int slot, int gi, int b) {\n",
         "  auto issue = [&](int slot, int gi, int b) {\n    if (slot >= 0) return;\n"),
        ("  auto flush = [&](int b, bool last) {\n",
         "  auto flush = [&](int b, bool last) {\n    if (b >= 0) return;\n")],
    # clock64 sums of the first consumer warp of each CTA: the whole loop,
    # the waits for a stage's copies, the waits for products, the flushes
    # and the issues, read back through w4_prof_fetch
    "timeline": [
        ('#include "w4_stream.cuh"\n',
         '#include "w4_stream.cuh"\n__device__ unsigned long long g_prof[8];\n'
         'extern "C" int w4_prof_fetch(void* d) { return cudaMemcpyFromSymbol(d, g_prof, 64); }\n'
         'extern "C" int w4_prof_reset() { unsigned long long z[8] = {}; '
         'return cudaMemcpyToSymbol(g_prof, z, 64); }\n'),
        ("  auto issue = [&](int slot, int gi, int b) {\n",
         "  long long p_mma = 0;\n  auto issue = [&](int slot, int gi, int b) {\n"),
        ("    hopper::wgmma_fence();\n#pragma unroll\n"
         "    for (int s = 0; s < 4; ++s) wgmma_rs(acc[b], a[b][s], db + 2 * s, s);\n"
         "    hopper::wgmma_commit();\n",
         "    const long long c2 = clock64();\n    hopper::wgmma_fence();\n#pragma unroll\n"
         "    for (int s = 0; s < 4; ++s) wgmma_rs(acc[b], a[b][s], db + 2 * s, s);\n"
         "    hopper::wgmma_commit();\n    p_mma += clock64() - c2;\n"),
        ("  for (int k = 0; k < total; ++k) {\n    const int ng",
         "  long long p_t0 = clock64(), p_full = 0, p_w = 0, p_fl = 0, p_is = 0, c;\n"
         "  for (int k = 0; k < total; ++k) {\n    const int ng"),
        ("        issue(slot, gi + 1, (gi + 1) & 1);",
         "        c = clock64(); issue(slot, gi + 1, (gi + 1) & 1); p_is += clock64() - c;"),
        ("        if (next) w4s::bar_wait(&full[nslot], npass & 1);\n"
         "        load(next ? nslot : slot, 0);\n        issue(next ? nslot : slot, 0, 0);",
         "        c = clock64(); if (next) w4s::bar_wait(&full[nslot], npass & 1);"
         " p_full += clock64() - c;\n"
         "        c = clock64(); load(next ? nslot : slot, 0); issue(next ? nslot : slot, 0, 0);"
         " p_is += clock64() - c;"),
        ("      hopper::wgmma_wait<1>();\n      if (gi < ng) {\n"
         "        flush(gi & 1, --kleft == 0);",
         "      c = clock64(); hopper::wgmma_wait<1>(); p_w += clock64() - c;\n      if (gi < ng) {\n"
         "        c = clock64(); flush(gi & 1, --kleft == 0); p_fl += clock64() - c;"),
        ("  hopper::wgmma_wait<0>();\n}\n",
         "  hopper::wgmma_wait<0>();\n"
         "  if (lane == 0 && warp == 0) {\n"
         "    atomicAdd(&g_prof[0], (unsigned long long)(clock64() - p_t0));\n"
         "    atomicAdd(&g_prof[1], (unsigned long long)p_full);\n"
         "    atomicAdd(&g_prof[2], (unsigned long long)p_w);\n"
         "    atomicAdd(&g_prof[3], (unsigned long long)p_fl);\n"
         "    atomicAdd(&g_prof[4], (unsigned long long)p_is);\n"
         "    atomicAdd(&g_prof[5], (unsigned long long)total);\n"
         "    atomicAdd(&g_prof[6], 1ull);\n"
         "    atomicAdd(&g_prof[7], (unsigned long long)p_mma);\n  }\n}\n")],
}


def _build(out_dir, diag):
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(os.path.join(HERE, "csrc"), out_dir)
    src = os.path.join(out_dir, "w4_grouped.cu")
    if diag:
        text = open(src).read()
        for old, new in DIAGNOSTICS[diag]:
            if old not in text:
                raise RuntimeError(f"{diag}: no {old!r} to edit")
            text = text.replace(old, new)
        open(src, "w").write(text)
    lib = os.path.join(out_dir, "lib.so")
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="base,nocodes,noweights,nomma,noflush,nocompute,timeline")
    ap.add_argument("--shapes", default="128x4096x4096,128x4096x12288")
    ap.add_argument("--copies", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from lavida_mod_tpu_torch import kernels
    from lavida_mod_tpu_torch.kernel_times import cuda_ms
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_grouped as tg
    from lavida_mod_tpu_torch.ops.w8a8 import ACT_FORMULA_W4_RECIP, act_quant

    if not torch.cuda.is_available():
        raise RuntimeError("w4_decode_variants.py needs a CUDA device")
    variants = args.variants.split(",")
    for v in variants:
        if v != "base" and v not in DIAGNOSTICS and not re.fullmatch(
                r"rb(16|32|48|64)", v):
            raise ValueError(f"unknown variant {v!r}")
    kernels.library()
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {v: _build(os.path.join(tmp, v), v if v in DIAGNOSTICS
                          else None) for v in variants}
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for v, (lib, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {v}:\n{log[-3000:]}")
            regs = re.findall(r"w4_decode_kernelILi(\d+)E[^']*'[\s\S]*?"
                              r"Used (\d+) registers", log)
            print(f"[variants] {v}: ptxas registers by rb {regs}")
            so = ctypes.CDLL(lib)
            fn = so.lavida_w4_grouped_decode
            fn.argtypes = [vp] * 5 + [ci] * 9 + [vp]
            fn.restype = ci
            fn.so = so
            fns[v] = fn
        run_shapes(torch, tq, tg, act_quant, ACT_FORMULA_W4_RECIP, cuda_ms,
                   fns, args)


def run_shapes(torch, tq, tg, act_quant, formula, cuda_ms, fns, args):
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"[variants] {name}, {sms} SMs, {args.copies} weight copies")
    stream = torch.cuda.current_stream().cuda_stream
    for shape in args.shapes.split(","):
        T, K, N = map(int, shape.split("x"))
        x = torch.randn(T, K, device=dev, generator=gen).bfloat16()
        packed, scales, _ = tq.quantize_linear4(
            torch.randn(N, K, device=dev, generator=gen) * 0.02)
        weights = [(packed, scales)] + [
            (packed.clone(), scales.clone()) for _ in range(args.copies - 1)]
        ref = tg.w4_matmul_grouped_reference(x, packed, scales)
        Np = packed.shape[0] * 8
        gb = tg.groups_per_kblock(K)
        calls = {}
        for v, fn in fns.items():
            p = (tg.decode_layout(T, Np, sms, int(v[2:])) if v.startswith("rb")
                 else tg.decode_plan(T, Np, sms))
            print(f"[variants] {v} {shape}: {p}")
            out = torch.zeros(T, Np, dtype=torch.bfloat16, device=dev)
            it = iter(range(1 << 62))

            def call(fn=fn, out=out, it=it, p=p, v=v):
                pk, sc = weights[next(it) % len(weights)]
                x8, sx = act_quant(x, formula)
                err = fn(x8.data_ptr(), sx.data_ptr(), pk.data_ptr(),
                         sc.data_ptr(), out.data_ptr(), T, K, Np, gb, p.rb,
                         p.row_blocks, p.ctas, p.stages, p.smem, stream)
                if err:
                    raise RuntimeError(f"{v}: returned {err}")

            call()
            torch.cuda.synchronize()
            exact = torch.equal(out, ref)
            err = ((out.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            print(f"[variants] {v} {shape}: {'exact' if exact else 'differs'}"
                  f", max error {err:.3e} of the plain version's max")
            calls[v] = call
        times = {v: [] for v in calls}
        for rnd in range(2):
            for v in (list(calls) if rnd == 0 else list(calls)[::-1]):
                times[v].append(cuda_ms(calls[v]))
        for v, t in times.items():
            print(f"[variants] {v} {shape}: device "
                  f"{' / '.join(f'{ms:.4f}' for ms in t)} ms per call, the "
                  f"row quantization included ({name})")
        if "timeline" in calls:
            so = fns["timeline"].so
            so.w4_prof_reset()
            calls["timeline"]()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            so.w4_prof_fetch(buf)
            loop, full, wait, flush, issue, stages, warps, mma = buf[:8]
            per = max(stages, 1)
            print(f"[variants] timeline {shape}: per stage of a consumer "
                  f"warp, cycles: loop {loop / per:.0f}, waits for copies "
                  f"{full / per:.0f}, waits for products {wait / per:.0f}, "
                  f"flushes {flush / per:.0f}, issues {issue / per:.0f} (of "
                  f"which the wgmma instructions {mma / per:.0f}), "
                  f"the rest {(loop - full - wait - flush - issue) / per:.0f}"
                  f" ({warps} warps, {stages} stages)")


if __name__ == "__main__":
    main(sys.argv[1:])
