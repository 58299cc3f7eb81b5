#!/usr/bin/env python3
"""Time #11 `w4_matmul` (csrc/w4_matmul.cu) built with diagnostic or
design edits, beside the kernel as it is, in turns in one process on one
CUDA card:

    python3 lavida_mod_tpu_torch/w4_matmul_variants.py
        [--variants base,nomma,nowiden,noload,cpasync] [--shapes decode,prefill,ragged]

Each variant is this tree's csrc/w4_matmul.cu (with the headers it
includes) compiled by its own nvcc, all in parallel, and called through
`lavida_w4_matmul` on the plan of ops/w4_matmul.py.  A variant is `base`
or parts joined by "+":
  nomma     no wgmma: the fragments are widened and dropped;
  nowiden   the loaded bytes passed to wgmma as they are (no widening);
  noload    no copies: the ring's barriers are signalled over stale
            shared memory;
  nox       no x tiles copied (TMA shapes only; the weights still come);
  now       no weight tiles copied (TMA shapes only; x still comes);
  cpasync   both operands by the cp.async path, as TMA-refused shapes run;
  n8        each product's N cut to 8 rows (its accumulator's first 4
            registers), whatever the row block: the products' cost at
            small N;
  noepi     no output stores (the split partials still go);
  timeline  clock64 stamps of consumer thread 0 of each CTA (kernel entry,
            each unit's start, first stage ready and last products done,
            the exit), printed as medians over the CTAs after the timing;
  btN       the prefill plan's rows per unit forced to N (128 or 256;
            the decode plan keeps its own); sN: the plan's K splits
            forced to N (the largest count up to N that leaves no split
            empty).
Printed: each build's registers and spills, and per shape (the decode
[32, 4096] x 12288, the prefill [1056, 4096] x 12288, the ragged [5, 4304]
x 1000; kernel_times.W4MM_CASES) each variant's plan, its device time per
call with the weights cold in L2 (kernel_times.cuda_ms; weight copies of
100 MB or more cycled) in two rounds, the second in reverse order, and its
largest error against the plain version (diagnostic variants are wrong by
design).  A variant that does not build is reported and left out.
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
WGMMA = ('''        wgmma_rs<BT>(acc, a[kk & 1][0], de + 2 * kk, kk > 0 || kb > kb0);
        wgmma_rs<BT>(acc, a[kk & 1][1], dodd + 2 * kk, 1);
''')
EDITS = {
    "nomma": [(WGMMA, "")],
    "nowiden": [("  const uint32_t w01 = __byte_perm(v0, v1, 0x5410), w89 = __byte_perm(v8, v9, 0x5410);",
                 "  a[0][0] = a[1][1] = a[0][2] = a[1][3] = v0 ^ v8;\n"
                 "  a[1][0] = a[0][1] = a[1][2] = a[0][3] = v1 ^ v9;\n  return;\n"
                 "  const uint32_t w01 = __byte_perm(v0, v1, 0x5410), w89 = __byte_perm(v8, v9, 0x5410);")],
    "noload": [("          if (!gx) hopper::tma_load_3d(st, &tm_x, bar, k0, t0, 0);\n"
                "          if (!gw) hopper::tma_load_2d(st + 2 * BT * 128, &tm_w, bar, n0, k0);\n", ""),
               ("            hopper::mbar_expect_tx(bar, tma_bytes);", "            hopper::mbar_arrive(bar);"),
               ("                         \"r\"(tma_bytes)", "                         \"r\"(0)"),
               ("  for (int c = pt; c < 2 * BT * kPer; c += kProducers) {",
                "  for (int c = pt + 2 * BT * kPer; c < 2 * BT * kPer; c += kProducers) {"),
               ("  for (int c = pt; c < kBK * kPer; c += kProducers) {",
                "  for (int c = pt + kBK * kPer; c < kBK * kPer; c += kProducers) {")],
    "nox": [("          if (!gx) hopper::tma_load_3d(st, &tm_x, bar, k0, t0, 0);\n", ""),
            ("(gx ? 0 : 2 * BT * 128)", "0")],
    "now": [("          if (!gw) hopper::tma_load_2d(st + 2 * BT * 128, &tm_w, bar, n0, k0);\n", ""),
            ("(gw ? 0 : kBK * kCols)", "0")],
    "cpasync": [("  if (gx == 16) {", "  if (false) {"), ("  if (gw == 16) {", "  if (false) {")],
    "timeline": [
        ("namespace {\n\n// The plan's constants",
         "__device__ long long g_tl[kTlCtas * 32];\n"
         "extern \"C\" int lavida_w4_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_tl, sizeof g_tl));\n}\n"
         "#define TL(i) do { if (threadIdx.x == 0 && blockIdx.x < kTlCtas && (i) < 32) "
         "g_tl[blockIdx.x * 32 + (i)] = clock64(); } while (0)\n"
         "namespace {\n\n// The plan's constants"),
        ("#include \"w4_stream.cuh\"\n", "#include \"w4_stream.cuh\"\nconstexpr int kTlCtas = 132;\n"),
        ("  const int kblocks = (K2 + kBK - 1) / kBK;\n  // gx / gw == 0",
         "  const int kblocks = (K2 + kBK - 1) / kBK;\n  TL(0);\n  // gx / gw == 0"),
        ("  int slot = 0, pass = 0;\n  for (int u = blockIdx.x; u < units; u += gridDim.x) {\n",
         "  int slot = 0, pass = 0, lu = -1;\n  for (int u = blockIdx.x; u < units; u += gridDim.x) {\n"
         "    ++lu;\n    TL(1 + 3 * lu);\n"),
        ("      w4s::bar_wait(&full[slot], pass & 1);\n      const uint32_t st = ring_s",
         "      w4s::bar_wait(&full[slot], pass & 1);\n      if (kb == kb0) TL(2 + 3 * lu);\n"
         "      const uint32_t st = ring_s"),
        ("    hopper::wgmma_wait<0>();\n    hopper::fence_acc(acc);\n",
         "    hopper::wgmma_wait<0>();\n    hopper::fence_acc(acc);\n    TL(3 + 3 * lu);\n"),
        ("      }\n  }\n}\n\n// The largest granule", "      }\n  }\n  TL(31);\n}\n\n// The largest granule"),
    ],
    "n8": [(WGMMA,
            "        wgmma_rs<8>(*reinterpret_cast<float(*)[4]>(acc), a[kk & 1][0], de + 2 * kk, kk > 0 || kb > kb0);\n"
            "        wgmma_rs<8>(*reinterpret_cast<float(*)[4]>(acc), a[kk & 1][1], dodd + 2 * kk, 1);\n")],
    "noepi": [("        if (t >= T) continue;", "        if (t >= 0) continue;")],
}
NAMES = {"decode", "prefill", "ragged"}


def _parts(variant):
    return variant.split("+")


def _edits(variant):
    out = []
    for part in _parts(variant):
        if part == "base" or re.fullmatch(r"(bt|s)\d+", part):
            continue
        if part not in EDITS:
            raise ValueError(f"unknown variant part {part!r}")
        out += EDITS[part]
    return out


def forced_plan(t4, T, K2, N, sms, bt=None, splits=None):
    """The plan of ops/w4_matmul.py with its rows per unit (prefill
    plans only) and its K splits forced (None: the plan's own)."""
    p = t4.plan(T, K2, N, sms)
    bt = bt if bt and p.regime == "prefill" else p.bt
    kps = -(-p.kblocks // (splits or p.splits))
    s = -(-p.kblocks // kps)
    rb = -(-T // bt)
    units = rb * p.col_tiles * s
    stages = t4.ring_stages(bt)
    return p._replace(bt=bt, row_blocks=rb, splits=s, kps=kps, units=units,
                      ctas=min(units, sms), stages=stages,
                      smem=1024 + stages * t4.stage_bytes(bt))


def timeline(torch, so, p):
    """Medians over the CTAs of the last launch's clock64 stamps (cycles):
    entry to the first unit's start, each unit's wait for its first stage,
    its stages, its epilogue (to the next unit's start or the exit)."""
    buf = torch.zeros(132 * 32, dtype=torch.int64)
    if so.lavida_w4_timeline(ctypes.c_void_p(buf.data_ptr())):
        return "unread"
    t = buf.view(132, 32).tolist()
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else -1
    n_units = [len(range(c, p.units, p.ctas)) for c in range(min(p.ctas, 132))]
    parts = {"entry_to_start": [], "exit": []}
    for c, n in enumerate(n_units):
        row = t[c]
        parts["entry_to_start"].append(row[1] - row[0])
        for lu in range(min(n, 9)):
            s0, r0, e0 = row[1 + 3 * lu: 4 + 3 * lu]
            nxt = row[1 + 3 * (lu + 1)] if lu + 1 < n else row[31]
            parts.setdefault(f"u{lu}_wait_first_stage", []).append(r0 - s0)
            parts.setdefault(f"u{lu}_stages", []).append(e0 - r0)
            parts.setdefault(f"u{lu}_epilogue", []).append(nxt - e0)
        parts["exit"].append(row[31] - row[0])
    return ", ".join(f"{k} {med(v)}" for k, v in parts.items())


def _build(out_dir, edits):
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(os.path.join(HERE, "csrc"), out_dir)
    src = os.path.join(out_dir, "w4_matmul.cu")
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
    ap.add_argument("--variants", default="base,nomma,nowiden,noload,cpasync")
    ap.add_argument("--shapes", default="decode,prefill,ragged")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from lavida_mod_tpu_torch.kernel_times import (W4MM_CASES,
                                                    W4MM_COLD_BYTES, cuda_ms)
    from lavida_mod_tpu_torch.ops import w4_matmul as t4

    if not torch.cuda.is_available():
        raise RuntimeError("w4_matmul_variants.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = args.variants.split(",")
    shapes = args.shapes.split(",")
    if not set(shapes) <= NAMES:
        raise ValueError(f"--shapes: {shapes}; the shapes are {sorted(NAMES)}")
    for v in variants:
        _edits(v)
    fns = {}
    name = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {v: _build(os.path.join(tmp, str(i)), _edits(v))
                for i, v in enumerate(variants)}
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for v, (lib, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(f"[variants] {v}: nvcc failed, left out:\n{log[-3000:]}")
                continue
            regs = re.findall(r"w4_matmul_kernelILi(\d+)E[^\n]*\n[^\n]*\n\s*(\d+) bytes stack frame, "
                              r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", log)
            print(f"[variants] {v}: ptxas " + ", ".join(
                f"bt {bt}: {r} registers, {sp} bytes spilled" for bt, _, sp, r in regs))
            so = ctypes.CDLL(lib)
            if "timeline" in _parts(v):
                so.lavida_w4_timeline.argtypes = [vp]
                so.lavida_w4_timeline.restype = ci
            fn = so.lavida_w4_matmul
            fn.argtypes = [vp] * 6 + [ci] * 10 + [vp]
            fn.restype = ci
            fn.so = so
            fns[v] = fn
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        for case, T, K, N in W4MM_CASES:
            if case not in shapes:
                continue
            x = torch.randn(T, K, device=dev, generator=gen).bfloat16()
            codes = torch.randint(-8, 8, (K, N), device=dev, generator=gen)
            packed = ((codes[1::2] & 0xF) << 4 | (codes[0::2] & 0xF)).to(
                torch.uint8).view(torch.int8).contiguous()
            scale = torch.rand(N, device=dev, generator=gen) * 0.01 + 0.005
            x2 = t4.split_even_odd(x)
            K2 = K // 2
            copies = max(3, -(-int(W4MM_COLD_BYTES) // (packed.numel() + 4 * N)))
            ws = [(packed, scale)] + [(packed.clone(), scale.clone())
                                      for _ in range(copies - 1)]
            ref = t4.w4_matmul_reference(x2, packed, scale).float()
            out = torch.empty(T, N, dtype=torch.bfloat16, device=dev)
            plans, calls = {}, {}
            for v, fn in fns.items():
                kw = {}
                for part in _parts(v):
                    m = re.fullmatch(r"(bt|s)(\d+)", part)
                    if m:
                        kw["bt" if m[1] == "bt" else "splits"] = int(m[2])
                p = forced_plan(t4, T, K2, N, sms, **kw)
                plans[v] = p
                part = torch.empty(max(p.part_floats, 1), device=dev)
                counters = torch.zeros(max(p.tiles, 1), dtype=torch.int32, device=dev)

                def call(fn=fn, p=p, part=part, counters=counters,
                         it=iter(range(1 << 62))):
                    pk, sc = ws[next(it) % copies]
                    err = fn(x2.data_ptr(), pk.data_ptr(), sc.data_ptr(),
                             out.data_ptr(), part.data_ptr(), counters.data_ptr(),
                             T, K2, N, p.bt, p.row_blocks, p.col_tiles, p.splits,
                             p.kps, p.ctas, p.smem,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{v}: cudaError_t {err}")
                    return out

                calls[v] = call
            times = {v: [] for v in calls}
            for rnd in range(2):
                for v in (list(calls) if rnd == 0 else list(calls)[::-1]):
                    times[v].append(cuda_ms(calls[v]))
            for v, call in calls.items():
                for _ in range(copies):     # the first copy's turn
                    o = call()
                if "timeline" in _parts(v):
                    torch.cuda.synchronize()
                    print(f"[variants] {case} {v} timeline: "
                          f"{timeline(torch, fns[v].so, plans[v])}")
                err = (o.float() - ref).abs().max().item()
                p = plans[v]
                print(f"[variants] {case} [{T},{K}]x[{K},{N}] {v}: "
                      f"{' / '.join(f'{t:.4f}' for t in times[v])} ms cold "
                      f"({copies} copies); plan bt {p.bt} x {p.row_blocks}, "
                      f"{p.col_tiles} column tiles, {p.splits} splits of "
                      f"{p.kps} stages, {p.ctas} CTAs; max error {err:.3e} "
                      f"({name})")
            del ws


if __name__ == "__main__":
    main(sys.argv[1:])
