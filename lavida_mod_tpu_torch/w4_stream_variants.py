#!/usr/bin/env python3
"""Time w4_qkv_norm (#5) or w4_matmul_res (#6) built with other stage
shapes of its weight-streaming GEMM, beside a checkout's, in turns in one
process on one CUDA card:

    python3 lavida_mod_tpu_torch/w4_stream_variants.py PARENT [--op qkv]
        [--variants 4x12,8x8,4x12:nomath] [--shapes 32x12288,32x126464]
        [--copies 4]
    python3 lavida_mod_tpu_torch/w4_stream_variants.py PARENT --op res
        [--variants 8x4,8x4@132,8x8] [--shapes 32x4096] [--copies 8]

PARENT is the root of another checkout (e.g. a `git archive` of the parent
commit); its csrc/w4_fused.cu is built as it is and called with its own
stage constants, or without a plan where its entry point takes none
(before the op ran on the streaming core).  Each variant is this tree's
csrc/w4_fused.cu with `kQkvSG, kQkvPU` (or `kResSG, kResPU`) set to SGxPU
(groups per stage, tiles per pass) and the plan the op's plan function
(ops/w4_fused.py::qkv_plan, ::res_plan) makes for them, or with C CTAs
for SGxPU@C; a shape whose ring the plan would refuse (fewer than
MIN_STAGES stages) is reported and not timed.  A variant may carry one
diagnostic edit of csrc/w4_stream.cuh:
  nomath  the consumer warps skip their products: the stream alone;
  noload  the producer skips the weight copies: the products, the codes'
          K-slices and the scales alone (the outputs are then wrong).
Each source is compiled by its own nvcc, all in parallel.  A shape is
ROWSxN at K = 4096.  `--copies` cycles the calls through that many copies
of the weights: one copy of [q|k|v] (26.7 MB) or of the output projection
(8.9 MB) stays in the 50 MB L2 from call to call; four of [q|k|v] (107 MB)
or eight of the projection (71 MB) do not, as a request's 32 layers do
not.  Printed: each build's registers, each variant's plan, its error
against the plain version, its device time per call (kernel_times.cuda_ms)
in two rounds (the second in reverse order) and the time each of its
kernels adds (kernel_times.kernel_split).
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
KERNEL_NAME = re.compile(r"(\w+(<[^>]*>)?)\(")   # in a profiler's kernel key
# per op: the stage constants' name in w4_fused.cu, the C entry point, its
# GEMM kernel, the default variants and shapes
OPS = {"qkv": ("Qkv", "lavida_w4_qkv_norm", "qkv_kernel",
               "4x12,8x8,4x8,2x12,4x16,8x4",
               "32x12288,32x126464,128x126464"),
       "res": ("Res", "lavida_w4_matmul_res", "res_kernel",
               "8x4,8x4@132,4x4,16x4,8x8,4x8,8x4:nomath,8x4:noload",
               "32x4096")}
DIAGNOSTICS = {
    "nomath": [("group(st + L::kASlice, a_addr, gi, j * SG + gi, ul);", ";")],
    "noload": [("kRows * (ng * kGroup + kPad) + nu * NT * ng * 512",
                "kRows * (ng * kGroup + kPad)"),
               ("for (int c = lane; c < nu * NT; c += 32) {",
                "for (int c = lane; c < 0 * nu; c += 32) {")],
}


def _edit(path, pairs):
    text = open(path).read()
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"{path}: no {old!r} to edit")
        text = text.replace(old, new)
    open(path, "w").write(text)


def _build(csrc, out_dir, const, variant=None):
    """Start nvcc on a copy of `csrc`'s w4_fused.cu, edited for `variant`
    (sg, pu, diagnostic) of the GEMM whose constants are k{const}SG and
    k{const}PU; return (library path, process, (sg, pu) of that GEMM or
    None where the op takes no plan)."""
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(csrc, out_dir)
    src = os.path.join(out_dir, "w4_fused.cu")
    stage = re.search(rf"k{const}SG = (\d+), k{const}PU = (\d+);",
                      open(src).read())
    if variant is not None:
        sg, pu, diag, _ = variant
        _edit(src, [(stage[0], f"k{const}SG = {sg}, k{const}PU = {pu};")])
        if diag:
            _edit(os.path.join(out_dir, "w4_stream.cuh"), DIAGNOSTICS[diag])
    lib = os.path.join(out_dir, "lib.so")
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), (
        variant[:2] if variant else stage and tuple(map(int, stage.groups())))


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--op", choices=sorted(OPS), default="qkv")
    ap.add_argument("--variants")
    ap.add_argument("--shapes")
    ap.add_argument("--copies", type=int, default=1)
    args = ap.parse_args(argv)
    const, entry, gemm, default_variants, default_shapes = OPS[args.op]
    args.variants = args.variants or default_variants
    args.shapes = args.shapes or default_shapes
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from lavida_mod_tpu_torch.kernel_times import cuda_ms, kernel_split
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_fused as tw

    if not torch.cuda.is_available():
        raise RuntimeError("w4_stream_variants.py needs a CUDA device")
    variants = []
    for v in args.variants.split(","):
        shape, _, diag = v.partition(":")
        if diag and diag not in DIAGNOSTICS:
            raise ValueError(f"unknown diagnostic {diag!r}")
        shape, _, ctas = shape.partition("@")
        variants.append((*map(int, shape.split("x")), diag, int(ctas or 0)))
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"parent": _build(os.path.join(
            args.parent, "lavida_mod_tpu_torch", "csrc"),
            os.path.join(tmp, "parent"), const)}
        for v in variants:
            jobs[v] = _build(os.path.join(HERE, "csrc"),
                             os.path.join(tmp, "v%d_%d_%s_%d" % v), const, v)
        fns = {}
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for key, (lib, proc, stage) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
            m = re.search(rf"entry function '[^']*({gemm}|w4_gemm_kernel)"
                          r"[^']*'[\s\S]*?(Used \d+ registers[^\n]*)", log)
            print(f"[variants] {key}: ptxas {m[2] if m else 'no report'}")
            fn = getattr(ctypes.CDLL(lib), entry)
            fn.argtypes = [vp] * 7 + [ci] * 3 + [cf] * (args.op == "qkv") \
                + [ci] * (3 if stage else 0) + [vp]
            fn.restype = ci
            fns[key] = fn, stage
        run_shapes(torch, tq, tw, cuda_ms, kernel_split, fns, args)


def run_shapes(torch, tq, tw, cuda_ms, kernel_split, fns, args):
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    D = 4096
    G = D // 128
    print(f"[variants] {args.op}: {name}, {sms} SMs, {args.copies} weight "
          f"copies")
    for shape in args.shapes.split(","):
        T, N = map(int, shape.split("x"))
        x = torch.randn(T, D, device=dev, generator=gen).bfloat16()
        nw = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).bfloat16()
        res = torch.randn(T, N, device=dev, generator=gen).bfloat16()
        packed, scales, _ = tq.quantize_linear4(
            torch.randn(N, D, device=dev, generator=gen) * 0.02)
        weights = [(packed[:N // 8].contiguous(),
                    scales[:, :N].contiguous())]
        weights += [tuple(t.clone() for t in weights[0])
                    for _ in range(args.copies - 1)]
        if args.op == "qkv":
            ref = tw.w4_qkv_norm_reference(x, nw, *weights[0], 1e-5)
            lead, tail = (x, nw), (1e-5,)
        else:
            ref = tw.w4_matmul_res_reference(x, res, *weights[0])
            lead, tail = (x, res), ()
        ref = ref.float()
        # room for either entry's scratch: the codes [T, D] and their
        # scales, or 32 rows in the slice layout of SG >= 2 and the scales
        work = torch.empty(T * D + tw.slice_bytes(2, G) + 4 * T + 256,
                           dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for key, (fn, stage) in fns.items():
            out = torch.zeros(T, N, dtype=torch.bfloat16, device=dev)
            it = iter(range(1 << 62))
            if stage is None:    # the codes [T, D], then their scales
                plan, sx = (), work.data_ptr() + T * D
            else:                # the codes in the slice layout, then sx
                ctas = (key[3] if key != "parent" and key[3] else sms
                        if args.op == "qkv" else tw.whole_pass_ctas(
                            N // 8, stage[1], sms))
                g = tw._gemm_plan(G, N // 8, 1, *stage, ctas)
                print(f"[variants] {key} [{T},{D}]x{N}: {g}")
                if g.stages < tw.MIN_STAGES:
                    print(f"[variants] {key} [{T},{D}]x{N}: not timed, "
                          f"the plan refuses {g.stages} stages")
                    continue
                plan = (g.ctas, g.stages, g.smem)
                sx = work.data_ptr() + -(-tw.slice_bytes(stage[0], G)
                                         // 128) * 128

            def call(fn=fn, out=out, it=it, plan=plan, sx=sx):
                pk, sc = weights[next(it) % len(weights)]
                err = fn(*(t.data_ptr() for t in lead), pk.data_ptr(),
                         sc.data_ptr(), work.data_ptr(), sx, out.data_ptr(),
                         T, D, N, *tail, *plan, stream)
                if err:
                    raise RuntimeError(f"{args.op}: {key} returned {err}")

            call()
            torch.cuda.synchronize()
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            print(f"[variants] {key} [{T},{D}]x{N}: err {err:.3e} against "
                  f"the plain version")
            calls[key] = call
        times = {key: [] for key in calls}
        for rnd in range(2):
            for key in (list(calls) if rnd == 0 else list(calls)[::-1]):
                times[key].append(cuda_ms(calls[key]))
        for key, t in times.items():
            split = kernel_split(torch, calls[key])
            parts = ", ".join(
                f"{KERNEL_NAME.search(k)[1]} adds {a:.4f} (runs {m:.4f})"
                for k, (a, m) in sorted(split.items(),
                                        key=lambda kv: -kv[1][0]))
            print(f"[variants] {key} [{T},{D}]x{N}: device "
                  f"{' / '.join(f'{v:.4f}' for v in t)} ms per call; {parts}"
                  f" ({name})")


if __name__ == "__main__":
    main(sys.argv[1:])
