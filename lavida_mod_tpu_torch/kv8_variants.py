#!/usr/bin/env python3
"""Time kv8_decode_attention's kernel (#8, csrc/kv8_attention.cu) built
with diagnostic or design edits, beside the kernel as it is, in turns in
one process on one CUDA card:

    python3 lavida_mod_tpu_torch/kv8_variants.py
        [--variants base,nocompute,noload,noconv,fastexp,src=PATH]
        [--shapes 4x32x32x32x1184] [--caches 4]

Each variant is this tree's csrc/kv8_attention.cu (with the headers it
includes) compiled by its own nvcc, all in parallel, and called through
`lavida_kv8_decode_attention` with the plan of ops/kv8_attention.py::
kv8_plan.  A variant is `base` or edits joined by "+":
  nocompute  the warps skip every key group's work (products, softmax)
             but wait for each tile: the ring alone;
  noload     no copies: each stage's barrier completes at once, and the
             warps run alone on stale shared memory;
  noepi      the warps stop after the last tile: no merge of the key
             splits, no output;
  stN        the plan with N ring stages (shared memory to match);
  timeline   exact, with clock64 sums of each warp of CTA 0 (its
             first launch): cycles waiting for tiles, in Q K^T (to the
             scaled scores), in the softmax (to the packed P) and in P V
             (to its last product), and the whole loop, printed by the card;
  nomma      each product replaced by four float adds of its operands'
             bits (no tensor cores; the widening stays);
  asm        the products as non-volatile asm, free to move;
  noconv     `widen` returns its words as they are (no conversion; the
             compiler drops the unused arithmetic);
  fastexp    the softmax's exponentials as __expf (ex2.approx), exact to
             the band;
  src=PATH   another kv8_attention.cu with the same entry point and plan
             constants (an earlier design kept outside the tree), as it is.
A shape is BxTxHxHkvxS (hd 128; each batch row front-padded as
generate_batch pads).  `--caches` cycles the calls through that many
caches, so that they are cold in the 50 MB L2 as a batch's 32 layers find
them.  Printed: each build's registers (and spills), each variant's plan
and error against the plain version, and its device time per call
(kernel_times.cuda_ms) in two rounds, the second in reverse order; beside
them, what the card streams: torch's copy of as many bytes as one cache's
K and V.  A variant that does not build is reported and left out.
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
    "nocompute": [("    for (int kg = ksi; kg < kKeys / kGroup && ",
                   "    for (int kg = ksi; kg < 0 && ")],
    "noload": [
        ("    hopper::mbar_expect_tx(bar, 2 * L::kTile);", "    hopper::mbar_arrive(bar);"),
        ("    for (int bx = 0; bx < L::kBoxes; ++bx) {", "    for (int bx = 0; bx < 0; ++bx) {"),
        ("  for (int e = lane; e < nk; e += 32) {", "  for (int e = lane; e < 0; e += 32) {"),
        ("  if (vrow != nullptr) {\n    const uintptr_t a", "  if (false) {\n    const uintptr_t a")],
    "noepi": [("  if (splits > 1) {\n    constexpr int kSlot",
               "  if (S > 0) return;\n  if (splits > 1) {\n    constexpr int kSlot")],
    "nomma": [("""  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
               """  c[0] += __uint_as_float(a[0] ^ b0);
  c[1] += __uint_as_float(a[1] ^ b1);
  c[2] += __uint_as_float(a[2]);
  c[3] += __uint_as_float(a[3]);""")],
    "asm": [("  asm volatile(\n      \"mma.sync", "  asm(\n      \"mma.sync")],
    "noconv": [("  return __byte_perm(__float_as_uint(fx), __float_as_uint(fy), 0x7632);",
                "  return x ^ y;")],
    "fastexp": [("expf(", "__expf(")],
}
EXACT = ("base", "fastexp", "timeline", "asm")


def _build(out_dir, edits, source=None):
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(os.path.join(HERE, "csrc"), out_dir)
    src = os.path.join(out_dir, "kv8_attention.cu")
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
    ap.add_argument("--variants",
                    default="base,nocompute,noload,noconv,fastexp")
    ap.add_argument("--shapes", default="4x32x32x32x1184")
    ap.add_argument("--caches", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from lavida_mod_tpu_torch.kernel_times import cuda_ms
    from lavida_mod_tpu_torch.ops import kv8_attention as tk

    if not torch.cuda.is_available():
        raise RuntimeError("kv8_variants.py needs a CUDA device")
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
            e for part in v.split("+") for e in EDITS.get(part, [])],
            v[4:] if v.startswith("src=") else None)
            for i, v in enumerate(variants)}
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for v, (lib, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(f"[variants] {v}: nvcc failed, left out:\n{log[-3000:]}")
                continue
            m = re.search(r"kv8_kernelILi128E[^']*' for 'sm_90a'\n([\s\S]*?"
                          r"Used \d+ registers[^\n]*)", log)
            print(f"[variants] {v}: ptxas {' '.join(m[1].split()) if m else '?'}")
            so = ctypes.CDLL(lib)
            fn = so.lavida_kv8_decode_attention
            fn.argtypes = [vp] * 8 + [ci] * 6 + [cf] + [ci] * 6 + [vp]
            fn.restype = ci
            fn.so = so
            fns[v] = fn
        run_shapes(torch, tk, cuda_ms, fns, args)


def run_shapes(torch, tk, cuda_ms, fns, args):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = torch.cuda.get_device_name(0)
    hd = 128
    for shape in args.shapes.split(","):
        B, T, H, Hkv, S = map(int, shape.split("x"))
        q = torch.randn(B, T, H, hd, device=dev, generator=gen).bfloat16()
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        for b in range(B):
            valid[b, :(37 * b) % (S // 4)] = False
        caches = []
        for _ in range(args.caches):
            k8, ks = tk.quantize_kv(torch.randn(B, S, Hkv, hd, device=dev,
                                                generator=gen).bfloat16())
            v8, vs = tk.quantize_kv(torch.randn(B, S, Hkv, hd, device=dev,
                                                generator=gen).bfloat16())
            caches.append((k8, ks, v8, vs))
        ref = tk.kv8_decode_attention_reference(q, *caches[0], valid)
        calls = {}
        for v, fn in fns.items():
            p = tk.kv8_plan(B, T, H, Hkv, S, hd, sms)
            st = [int(x[2:]) for x in v.split("+") if re.fullmatch(r"st\d", x)]
            if st:
                p = p._replace(stages=st[0], smem=p.smem - (p.stages - st[0])
                               * tk.kv8_stage_bytes(hd))
            out = torch.empty_like(q)
            ws = torch.empty(max(1, p.units * p.row_tiles * 16 * (hd + 2)),
                             dtype=torch.float32, device=dev)
            it = iter(range(1 << 62))

            def call(fn=fn, p=p, out=out, ws=ws, it=it, v=v):
                k8, ks, v8, vs = caches[next(it) % len(caches)]
                err = fn(q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
                         v8.data_ptr(), vs.data_ptr(), valid.data_ptr(),
                         out.data_ptr(), ws.data_ptr(), B, T, H, Hkv, S, hd,
                         1.0 / hd ** 0.5, p.row_tiles, p.row_blocks,
                         p.splits, p.chunks, p.stages, p.smem,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{v}: cudaError_t {err}")
                return out

            it0 = iter(range(1 << 62))
            o = call(it=it0)   # caches[0]
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            tag = "" if all(part in EXACT or part.startswith("src=")
                            for part in v.split("+")) else " (diagnostic)"
            print(f"[variants] {v} q[{B},{T},{H},{hd}] Hkv {Hkv} S {S}: plan "
                  f"{tuple(p)}, max error {err:.3e} (limit 6e-3){tag}")
            calls[v] = call
        times = {v: [] for v in calls}
        for order in (list(calls), list(reversed(calls))):
            for v in order:
                times[v].append(cuda_ms(calls[v]))
        # a yardstick of what the card streams: torch's copy of as many
        # bytes (K and V of one cache) between two buffers, cycled as above
        kv = [torch.cat([c[0].view(-1), c[2].view(-1)]) for c in caches]
        dst = torch.empty_like(kv[0])
        it = iter(range(1 << 62))
        copy_ms = cuda_ms(lambda: dst.copy_(kv[next(it) % len(kv)]))
        print(f"[variants] yardstick {shape}: copy of the cache's "
              f"{kv[0].numel() / 1e6:.1f} MB {copy_ms:.4f} ms "
              f"({2 * kv[0].numel() / copy_ms / 1e9:.2f} TB/s read + write)")
        del kv, dst
        nbytes = 2 * B * Hkv * S * (hd + 4) + 4 * q.numel() + B * S
        bound = nbytes / 3.35e12 * 1e3
        for v, t in times.items():
            print(f"[variants] {v} {shape} ({args.caches} caches): "
                  f"{' / '.join(f'{x:.4f}' for x in t)} ms per call, bound "
                  f"{bound:.4f} ms ({100 * bound / min(t):.1f} % of it) "
                  f"({name})")
        del caches


if __name__ == "__main__":
    main(sys.argv[1:])
