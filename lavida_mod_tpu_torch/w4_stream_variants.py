#!/usr/bin/env python3
"""Time w4_qkv_norm (#5) built with other stage shapes of its weight-
streaming GEMM, beside a checkout's #5, in turns in one process on one
CUDA card:

    python3 lavida_mod_tpu_torch/w4_stream_variants.py PARENT
        [--variants 4x12,8x8,4x12:nomath] [--shapes 32x12288,32x126464]
        [--copies 4]

PARENT is the root of another checkout (e.g. a `git archive` of the parent
commit); its csrc/w4_fused.cu is built as it is and called with its own
stage constants, or without a plan where its `lavida_w4_qkv_norm` takes
none (before #5 ran on the streaming core).  Each variant is this tree's
csrc/w4_fused.cu with `kQkvSG, kQkvPU` set to SGxPU (groups per stage,
tiles per pass) and the plan from ops/w4_fused.py::_gemm_plan for them,
optionally with one diagnostic edit of csrc/w4_stream.cuh:
  nomath  the consumer warps skip their products: the stream alone;
  noload  the producer skips the weight copies: the products, the codes'
          K-slices and the scales alone (the outputs are then wrong).
Each source is compiled by its own nvcc, all in parallel.  A shape is
ROWSxN at D = 4096.  `--copies` cycles the calls through that many copies
of the weights: one copy of [q|k|v] (26.7 MB) stays in the 50 MB L2 from
call to call, four do not, as a request's 32 layers do not.  Printed: each
build's registers, each variant's plan, its error against the plain
version, its device time per call (kernel_times.cuda_ms) in two rounds
(the second in reverse order) and the time each of its kernels adds
(kernel_times.kernel_split).
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


def _build(csrc, out_dir, variant=None):
    """Start nvcc on a copy of `csrc`'s w4_fused.cu, edited for `variant`
    (sg, pu, diagnostic); return (library path, process, (sg, pu) of its
    #5 GEMM or None where its #5 takes no plan)."""
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(csrc, out_dir)
    src = os.path.join(out_dir, "w4_fused.cu")
    stage = re.search(r"kQkvSG = (\d+), kQkvPU = (\d+);", open(src).read())
    if variant is not None:
        sg, pu, diag = variant
        _edit(src, [(stage[0], f"kQkvSG = {sg}, kQkvPU = {pu};")])
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
    ap.add_argument("--variants", default="4x12,8x8,4x8,2x12,4x16,8x4")
    ap.add_argument("--shapes", default="32x12288,32x126464,128x126464")
    ap.add_argument("--copies", type=int, default=1)
    args = ap.parse_args(argv)
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
        variants.append((*map(int, shape.split("x")), diag))
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"parent": _build(os.path.join(
            args.parent, "lavida_mod_tpu_torch", "csrc"),
            os.path.join(tmp, "parent"))}
        for v in variants:
            jobs[v] = _build(os.path.join(HERE, "csrc"),
                             os.path.join(tmp, "v%d_%d_%s" % v), v)
        fns = {}
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for key, (lib, proc, stage) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
            m = re.search(r"entry function '[^']*(qkv_kernel|w4_gemm_kernel)"
                          r"[^']*'[\s\S]*?(Used \d+ registers[^\n]*)", log)
            print(f"[variants] {key}: ptxas {m[2] if m else 'no report'}")
            fn = ctypes.CDLL(lib).lavida_w4_qkv_norm
            fn.argtypes = [vp] * 7 + [ci] * 3 + [cf] + [ci] * (
                3 if stage else 0) + [vp]
            fn.restype = ci
            fns[key] = fn, stage
        run_shapes(torch, tq, tw, cuda_ms, kernel_split, fns, args)


def run_shapes(torch, tq, tw, cuda_ms, kernel_split, fns, args):
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    D = 4096
    print(f"[variants] {name}, {sms} SMs, {args.copies} weight copies")
    for shape in args.shapes.split(","):
        T, N = map(int, shape.split("x"))
        x = torch.randn(T, D, device=dev, generator=gen).bfloat16()
        nw = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).bfloat16()
        packed, scales, _ = tq.quantize_linear4(
            torch.randn(N, D, device=dev, generator=gen) * 0.02)
        weights = [(packed[:N // 8].contiguous(),
                    scales[:, :N].contiguous())]
        weights += [tuple(t.clone() for t in weights[0])
                    for _ in range(args.copies - 1)]
        ref = tw.w4_qkv_norm_reference(x, nw, *weights[0], 1e-5).float()
        # room for either entry's scratch: x8 [T, D] and sx, or 32 rows in
        # the slice layout of SG >= 2 and sx
        work = torch.empty(T * D + tw.slice_bytes(2, D // 128) + 4 * T + 256,
                           dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for key, (fn, stage) in fns.items():
            out = torch.zeros(T, N, dtype=torch.bfloat16, device=dev)
            it = iter(range(1 << 62))
            if stage is None:    # x8 [T, D], then sx
                plan, sx = (), work.data_ptr() + T * D
            else:                # x8 in the slice layout, then sx
                g = tw._gemm_plan(D // 128, N // 8, 1, *stage, sms)
                plan = (g.ctas, g.stages, g.smem)
                sx = work.data_ptr() + -(-tw.slice_bytes(stage[0], D // 128)
                                         // 128) * 128
                print(f"[variants] {key} [{T},{D}]x{N}: {g}")

            def call(fn=fn, out=out, it=it, plan=plan, sx=sx):
                pk, sc = weights[next(it) % len(weights)]
                err = fn(x.data_ptr(), nw.data_ptr(), pk.data_ptr(),
                         sc.data_ptr(), work.data_ptr(), sx, out.data_ptr(),
                         T, D, N, 1e-5, *plan, stream)
                if err:
                    raise RuntimeError(f"lavida_w4_qkv_norm returned {err}")

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
