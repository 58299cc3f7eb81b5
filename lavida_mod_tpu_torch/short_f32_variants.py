#!/usr/bin/env python3
"""Time #1's f32 instance (`attention_f32_tc_kernel` in
csrc/short_attention.cu) built with diagnostic or design edits, beside the
kernel as it is, in turns in one process on one CUDA card:

    python3 lavida_mod_tpu_torch/short_f32_variants.py
        [--variants base,nomma,nosplit,noload,cvt,exactexp,src=PATH]
        [--sass DIR]

Each variant is this tree's csrc/short_attention.cu (with the headers it
includes) cut to its hd 72 f32 instance and compiled by its own nvcc, all
in parallel, and called through `lavida_short_attention_f32`.  A variant
is `base` or edits joined by "+":
  nomma     each product replaced by float adds of its operands' bits (no
            tensor cores; the splits stay);
  nosplit   each operand passed whole as both of its TF32 halves (no split
            arithmetic);
  noload    no K/V copies: the warps run on stale shared memory;
  nopv      no O += P V products;
  nosoftmax the scores go to P V as they are (no masking, exponentials,
            row sums or rescaling);
  cvt       the TF32 rounding by cvt.rna.tf32.f32 (the same rounding as
            the integer arithmetic; a compare-and-select sequence);
  rawsmall  the small half's low 13 bits left to the tensor cores, which
            read a TF32 operand's top 19 bits (exact if they ignore the
            rest: compare with base);
  trunc     big = x with its low 13 bits cleared, small = x - big as it
            is (two operations; not the rounding the CPU tests emulate);
  exactexp  the softmax's exponentials as exp2f;
  keysN     K/V tiles of N keys; warpsN: N warps a CTA; stN: a ring of N
            stages; twoksN: two m16 tiles a warp up to hd 8 N (twoks0:
            one everywhere); ctasN: launch bounds for N CTAs an SM;
  src=PATH  another short_attention.cu with the same entry point, as it is.
Printed: each build's registers (and spills), each variant's largest
error against the plain version at the SHIRG-LoRA harness's tower
([4, 1024, 16, 72]) and at a ragged GQA case with rows that see no key
([2, 77, 8, 72] over 131 keys), and its device time per call at both
(kernel_times.cuda_ms) in two rounds, the second in reverse order, beside
SDPA in f32.  `--sass DIR` writes each build's SASS of the kernel there
and prints its instruction counts by opcode.  A variant that does not
build is reported and left out.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
MMA = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
SPLIT = ("  big = rna_tf32(__float_as_uint(x));\n"
         "  small = rna_tf32(__float_as_uint(x - __uint_as_float(big)));")
EDITS = {
    "nomma": [(MMA, """  d[0] += __uint_as_float(a[0] ^ b0);
  d[1] += __uint_as_float(a[1] ^ b1);
  d[2] += __uint_as_float(a[2]);
  d[3] += __uint_as_float(a[3]);""")],
    "nosplit": [(SPLIT, "  big = small = __float_as_uint(x);")],
    "noload": [("    cp_async16(stage + r * L::kHd + 4 * c, k + off, valid);\n"
                "    cp_async16(stage + L::kK + r * L::kHd + 4 * c, v + off, valid);\n",
                "")],
    "nopv": [("          for (int i = 0; i < MT; ++i) mma_3xtf32(o[i][n], pb[i], ps[i], vf.x, "
              "vf.y, vf.z, vf.w);",
              "          o[0][n][0] += __uint_as_float(vf.x ^ vf.w ^ pb[0][0] ^ ps[0][3]);")],
    "cvt": [("  return (bits + 0x1000u) & 0xffffe000u;",
             '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : '
             '"f"(__uint_as_float(bits)));\n  return r;')],
    "rawsmall": [(SPLIT, "  big = rna_tf32(__float_as_uint(x));\n"
                  "  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;")],
    "trunc": [(SPLIT, "  big = __float_as_uint(x) & 0xffffe000u;\n"
               "  small = __float_as_uint(x - __uint_as_float(big));")],
    "exactexp": [(" = ex2(", " = exp2f(")],
    "nosoftmax": [(re.compile(r"    // online softmax in the log2 domain"
                              r"[\s\S]*?(?=    // O \+= P V)"), "")],
}
KNOBS = {"keys": "constexpr int kTcKeys = ", "warps": "constexpr int kTcWarps = ",
         "st": "constexpr int kTcStages = ", "twoks": "constexpr int kTcMaxKs2 = ",
         "ctas": "__launch_bounds__(kTcThreads, "}
EXACT = ("base", "cvt", "rawsmall", "exactexp", "keys", "warps", "st", "twoks",
         "ctas")


def _edits(variant):
    out = []
    for part in variant.split("+"):
        m = re.fullmatch(r"(keys|warps|st|twoks|ctas)(\d+)", part)
        if m:
            end = ")" if m[1] == "ctas" else ";"
            out.append((re.compile(re.escape(KNOBS[m[1]]) + r"\d+" + re.escape(end)),
                        f"{KNOBS[m[1]]}{m[2]}{end}"))
        else:
            out += EDITS.get(part, [])
    return out


def hd72_only(text):
    """short_attention.cu with no case of either entry's switch but the
    hd 72 f32 instance's (one instance to build)."""
    return re.sub(r"\n    case (\d+): return launch(_f32)?<\d+>\([^\n]*",
                  lambda m: m[0] if m[2] and m[1] == "9" else "", text)


def _build(out_dir, edits, source=None):
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(os.path.join(HERE, "csrc"), out_dir)
    src = os.path.join(out_dir, "short_attention.cu")
    if source:
        shutil.copy(source, src)
    text = hd72_only(open(src).read())
    for old, new in edits:
        if isinstance(old, str):
            if old not in text:
                raise RuntimeError(f"{out_dir}: no {old!r} to edit")
            text = text.replace(old, new)
        else:
            text, n = old.subn(new, text)
            if not n:
                raise RuntimeError(f"{out_dir}: no {old.pattern!r} to edit")
    open(src, "w").write(text)
    lib = os.path.join(out_dir, "lib.so")
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _sass(lib, name, sass_dir):
    """Instruction counts by opcode of the f32 kernel in `lib`."""
    from lavida_mod_tpu_torch.kernels import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True).stdout
    m = re.search(r"Function : \S*attention_f32_tc_kernel\S*\n([\s\S]*?)"
                  r"(?:\n\s*\n\s*\.{5,}|\Z)", text)
    body = m[1] if m else ""
    os.makedirs(sass_dir, exist_ok=True)
    with open(os.path.join(sass_dir, f"{name}.sass"), "w") as f:
        f.write(body)
    ops = collections.Counter(
        mm[1].split(".")[0] for mm in
        re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                    body))
    return ops


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base,nomma,nosplit,noload")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    import torch.nn.functional as F

    from lavida_mod_tpu_torch.kernel_times import (SHORT_F32_CASES, cuda_ms,
                                                    short_f32_inputs)
    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention_reference)

    if not torch.cuda.is_available():
        raise RuntimeError("short_f32_variants.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = args.variants.split(",")
    for v in variants:
        for part in v.split("+"):
            if part != "base" and part not in EDITS \
                    and not part.startswith("src=") \
                    and not re.fullmatch(r"(keys|warps|st|twoks|ctas)\d+", part):
                raise ValueError(f"unknown variant {v!r}")
    fns = {}
    name = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {v: _build(os.path.join(tmp, str(i)), _edits(v), next(
            (p[4:] for p in v.split("+") if p.startswith("src=")), None))
                for i, v in enumerate(variants)}
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for i, (v, (lib, proc)) in enumerate(jobs.items()):
            log = proc.communicate()[0]
            if proc.returncode:
                print(f"[variants] {v}: nvcc failed, left out:\n{log[-3000:]}")
                continue
            m = re.search(r"attention_f32_tc_kernel[^']*' for 'sm_90a'\n"
                          r"([\s\S]*?Used \d+ registers[^\n]*)", log)
            print(f"[variants] {v}: ptxas "
                  f"{' '.join(m[1].split()) if m else '?'}")
            if args.sass:
                ops = _sass(lib, f"{i}_{re.sub(r'[^A-Za-z0-9+]', '_', v)}",
                            args.sass)
                print(f"[variants] {v}: SASS {sum(ops.values())} "
                      f"instructions: " + ", ".join(
                          f"{op} {n}" for op, n in ops.most_common(24)))
            so = ctypes.CDLL(lib)
            fn = so.lavida_short_attention_f32
            fn.argtypes = [vp] * 6 + [ci] * 6 + [cf, vp]
            fn.restype = ci
            fn.so = so
            fns[v] = fn
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        for case, qs, ks, kind, _ in SHORT_F32_CASES:
            q, k, v, sq, skv = short_f32_inputs(torch, dev, gen, qs, ks,
                                                kind)
            ref = short_attention_reference(q, k, v, sq, skv)
            out = torch.empty_like(q)
            B, T, H, hd = qs

            def call(fn, v=v, out=out):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         None if sq is None else sq.data_ptr(),
                         None if skv is None else skv.data_ptr(),
                         out.data_ptr(), B, T, ks[1], H, ks[2], hd,
                         1.0 / hd ** 0.5,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"cudaError_t {err}")
                return out

            mask = None if sq is None else (sq[:, None, :, None]
                                            == skv[:, None, None, :])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            G = qs[2] // ks[2]
            if G > 1:
                kt, vt = (t.repeat_interleave(G, 1) for t in (kt, vt))
            times = {v: [] for v in fns}
            sdpa = []
            for rnd in range(2):
                sdpa.append(cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)))
                for vname in (list(fns) if rnd == 0 else list(fns)[::-1]):
                    times[vname].append(cuda_ms(lambda: call(fns[vname])))
            first = None
            for vname, fn in fns.items():
                o = call(fn).clone()
                torch.cuda.synchronize()
                if first is None:
                    first = o
                err = (o - ref).abs().max().item()
                excess = ((o - ref).abs() / (2e-5 + 2e-5 * ref.abs())).max().item()
                exact = all(p.startswith(EXACT) or p.startswith("src=")
                            for p in vname.split("+"))
                print(f"[variants] {case} {vname}: "
                      f"{' / '.join(f'{t:.4f}' for t in times[vname])} ms "
                      f"(SDPA f32 {' / '.join(f'{t:.4f}' for t in sdpa)}); "
                      f"max error {err:.3e}, {excess:.3f} of the band, "
                      f"{(o - first).abs().max().item():.3e} from "
                      f"{list(fns)[0]}'s"
                      f"{'' if exact else ' (diagnostic)'} ({name})")


if __name__ == "__main__":
    main(sys.argv[1:])
