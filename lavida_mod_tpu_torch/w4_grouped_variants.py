#!/usr/bin/env python3
"""Time one of w4_matmul_grouped's kernels (#4, csrc/w4_grouped.cu) built
with diagnostic edits (or, for the decode kernel, another row split),
beside the kernel as it is, in turns in one process on one CUDA card:

    python3 lavida_mod_tpu_torch/w4_grouped_variants.py [--regime decode]
        [--variants base,nocodes,noweights,nomma,noflush,nocompute,rb64]
        [--shapes 128x4096x4096,128x4096x12288] [--copies 8]
    python3 lavida_mod_tpu_torch/w4_grouped_variants.py --regime prefill
        [--variants base,nocompute,noload,nomma,noflush,noload+noflush]
        [--shapes 4608x4096x4096]

Each variant is this tree's csrc/w4_grouped.cu (with the headers it
includes) compiled by its own nvcc, all in parallel, and called through
the regime's entry point (`lavida_w4_grouped_decode` or
`lavida_w4_grouped`) on the codes and row scales that the port's row
quantization makes of the same x.  A variant is `base` (the kernel as it
is), `rbN` (decode: the plan of ops/w4_grouped.py::decode_plan with N rows
per unit forced) or one diagnostic edit, whose outputs are then wrong
unless marked exact.  The decode kernel's:
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
The prefill kernel's (PREFILL_DIAGNOSTICS): nocompute, nomma and noflush
as above, for both consumer warpgroups, and
  noload     the producer fills the ring once, then releases its stages
             without copies: the consumers alone;
  flushhalf  the flush of half the outputs;
  noconv     the flush without the int-to-float conversion;
  magic      exact: the flush's conversion as an integer add into a
             float's mantissa and a float subtraction;
  turns      exact: the two warpgroups take turns on the tensor cores
             (named barriers), each issuing once the other's group is
             half done;
  halves     exact: each warpgroup's rows as two halves of 64, one half's
             products running while the other's are flushed;
  halvesnotot  the halves without `total` (exact where K/128 is one
             k-block): what they give once they fit in the registers;
  inflight2  two groups' products in flight per warpgroup, as the decode
             kernel keeps them (no `total`: exact where K/128 is one
             k-block);
  sgN        N groups per ring stage (as many stages as fit).
Diagnostics combine with "+" (noload+noflush: the products alone).  A
shape is TxKxN.  `--copies` cycles the calls through that many copies
of the weights, so that they are cold in the 50 MB L2 as a batch's 32
layers find them.  Printed: each build's registers (and spills), each
variant's plan and error against the plain version, and its device time
per call (kernel_times.cuda_ms) in two rounds, the second in reverse
order.  A variant that does not build is reported and left out.
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


# two groups' products in flight per warpgroup, as the decode kernel keeps
# them: a second accumulator instead of `total`, so the epilogue takes the
# partial as the total -- exact only where K is one k-block (K/128 == gb)
_PREFILL_INFLIGHT2 = '''  int acc[2][64];
  uint32_t a[2][4][4];
  float sc[2][2], part[64];
  uint4 nw[2];
  float ns[2];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  auto load = [&](int sl, int gi) {
    const uint32_t st = ring_s + sl * kPreStage;
    nw[0] = lds128(st + w_off + gi * 512);
    nw[1] = lds128(st + w_off + (kPreSG + gi) * 512);
    ns[0] = lds_f32(st + s_off + gi * kPreCols * 4);
    ns[1] = lds_f32(st + s_off + gi * kPreCols * 4 + 32);
  };
  auto issue = [&](int sl, int gi, int b) {
    const uint32_t v0[4] = {nw[0].x, nw[0].y, nw[0].z, nw[0].w};
    const uint32_t v1[4] = {nw[1].x, nw[1].y, nw[1].z, nw[1].w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[b][s][0] = (v0[s] << 4) & 0xF0F0F0F0u;
      a[b][s][1] = (v1[s] << 4) & 0xF0F0F0F0u;
      a[b][s][2] = v0[s] & 0xF0F0F0F0u;
      a[b][s][3] = v1[s] & 0xF0F0F0F0u;
    }
    sc[b][0] = ns[0] * 0.0625f;
    sc[b][1] = ns[1] * 0.0625f;
    const uint64_t db = desc0 + ((sl * kPreStage + gi * kPreRows * kGroup) >> 4);
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_rs(acc[b], a[b][s], db + 2 * s, s);
    hopper::wgmma_commit();
    if (gi + 1 < kPreSG) load(sl, gi + 1);
  };
  auto flush = [&](int b) {
    hopper::fence_acc(acc[b]);
#pragma unroll
    for (int s = 0; s < 4; ++s) hopper::fence_acc(a[b][s]);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      part[i] = __fadd_rn(part[i], __fmul_rn(__int2float_rn(acc[b][i]), sc[b][(i >> 1) & 1]));
  };
  static_assert(kPreSG % 2 == 0, "a stage's first group takes acc[0]");
  w4s::bar_wait(&full[0], 0);
  load(0, 0);
  issue(0, 0, 0);
  int slot = 0, pass = 0, j = 0, u = static_cast<int>(blockIdx.x);
  for (int k = 0; k < total; ++k) {
    float rs = 0.0f;
    if (j == 0) {
      const int t = u / col_tiles * kPreRows + (threadIdx.x & 127);
      if (t < T) rs = sx[t];
    }
    const int ng = min(kPreSG, G - j * kPreSG);
    const bool next = k + 1 < total;
    int nslot = slot + 1, npass = pass;
    if (nslot == stages) nslot = 0, ++npass;
#pragma unroll
    for (int gi = 0; gi < kPreSG; ++gi) {
      if (gi + 1 < kPreSG) {
        issue(slot, gi + 1, (gi + 1) & 1);
      } else {
        if (next) w4s::bar_wait(&full[nslot], npass & 1);
        load(next ? nslot : slot, 0);
        issue(next ? nslot : slot, 0, 0);
      }
      hopper::wgmma_wait<1>();
      if (gi < ng) flush(gi & 1);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    slot = nslot;
    pass = npass;
    if (j == 0) row_scales[wg][threadIdx.x & 127] = rs;
    if (++j == nslices) {
      asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");
      const int rblk = u / col_tiles;
      const int n = (u - rblk * col_tiles) * kPreCols + 64 * wg + 16 * warp + gid;
      if (n < N) {
#pragma unroll
        for (int jj = 0; jj < kPreRows / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 8 * jj + 2 * tig + c, t = rblk * kPreRows + r;
            if (t < T) {
              const float f = row_scales[wg][r];
              __nv_bfloat16* o = out + static_cast<long>(t) * N + n;
              o[0] = __float2bfloat16_rn(__fmul_rn(part[4 * jj + c], f));
              o[8] = __float2bfloat16_rn(__fmul_rn(part[4 * jj + 2 + c], f));
            }
          }
      }
      asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) part[i] = 0.0f;
      j = 0;
      u += ctas;
    }
  }
  hopper::wgmma_wait<0>();
}
'''
# each warpgroup's 128 rows as two halves of 64 (wgmma n64): one half's
# products run while the other half is flushed, the next group's first
# half issued before this group's second is flushed; no turns
_PREFILL_HALVES = """  int acc[2][32];
  uint32_t a[4][4];
  float part[64], tot[64], sc[2][2];
  uint4 nw0, nw1;
  float ns0, ns1;
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = tot[i] = 0.0f;
  // group gi's weights and scales of the stage at shared address st
  auto fetch = [&](uint32_t st, int gi) {
    nw0 = lds128(st + w_off + gi * 512);
    nw1 = lds128(st + w_off + (kPreSG + gi) * 512);
    ns0 = lds_f32(st + s_off + gi * kPreCols * 4);
    ns1 = lds_f32(st + s_off + gi * kPreCols * 4 + 32);
  };
  auto widen = [&](int b) {
    const uint32_t w0[4] = {nw0.x, nw0.y, nw0.z, nw0.w};
    const uint32_t w1[4] = {nw1.x, nw1.y, nw1.z, nw1.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[s][0] = (w0[s] << 4) & 0xF0F0F0F0u;
      a[s][1] = (w1[s] << 4) & 0xF0F0F0F0u;
      a[s][2] = w0[s] & 0xF0F0F0F0u;
      a[s][3] = w1[s] & 0xF0F0F0F0u;
    }
    sc[b][0] = ns0 * 0.0625f;
    sc[b][1] = ns1 * 0.0625f;
  };
  // rows 64 h .. 64 h + 63 of the group whose codes start at descriptor db
  auto issue = [&](uint64_t db, int h) {
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_rs(acc[h], a[s], db + h * 512 + 2 * s, s);
    hopper::wgmma_commit();
  };
  auto flush = [&](int h, int b) {
    hopper::fence_acc(acc[h]);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      part[32 * h + i] = __fadd_rn(part[32 * h + i],
                                   __fmul_rn(__int2float_rn(acc[h][i]), sc[b][(i >> 1) & 1]));
  };
  static_assert(kPreSG % 2 == 0, "a stage's first group takes sc[0]");
  int slot = 0, pass = 0, j = 0, u = static_cast<int>(blockIdx.x), kleft = gb;
  w4s::bar_wait(&full[0], 0);
  fetch(ring_s, 0);
  widen(0);
  issue(desc0, 0);
  for (int k = 0; k < total; ++k) {
    float rs = 0.0f;
    if (j == 0) {
      const int t = u / col_tiles * kPreRows + (threadIdx.x & 127);
      if (t < T) rs = sx[t];
    }
    const int ng = min(kPreSG, G - j * kPreSG);
    const bool next = k + 1 < total;
    int nslot = slot + 1, npass = pass;
    if (nslot == stages) nslot = 0, ++npass;
    const uint32_t st = ring_s + slot * kPreStage;
#pragma unroll
    for (int gi = 0; gi < kPreSG; ++gi) {
      // the group's second half, then the next group's weights
      issue(desc0 + ((slot * kPreStage + gi * kPreRows * kGroup) >> 4), 1);
      if (gi + 1 < kPreSG) {
        fetch(st, gi + 1);
      } else {
        if (next) w4s::bar_wait(&full[nslot], npass & 1);
        fetch(ring_s + (next ? nslot : slot) * kPreStage, 0);
      }
      hopper::wgmma_wait<1>();
      if (gi < ng) flush(0, gi & 1);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc[1]);
#pragma unroll
      for (int s = 0; s < 4; ++s) hopper::fence_acc(a[s]);
      // the next group's first half runs while this one's second is flushed
      widen((gi + 1) & 1);
      issue(desc0 + (gi + 1 < kPreSG
                         ? (slot * kPreStage + (gi + 1) * kPreRows * kGroup) >> 4
                         : ((next ? nslot : slot) * kPreStage) >> 4), 0);
      if (gi < ng) {
        flush(1, gi & 1);
        if (--kleft == 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            tot[i] = __fadd_rn(tot[i], part[i]);
            part[i] = 0.0f;
          }
          kleft = gb;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    slot = nslot;
    pass = npass;
    if (j == 0) row_scales[wg][threadIdx.x & 127] = rs;
    if (++j == nslices) {
      asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");
      const int rblk = u / col_tiles;
      const int n = (u - rblk * col_tiles) * kPreCols + 64 * wg + 16 * warp + gid;
      if (n < N) {
#pragma unroll
        for (int jj = 0; jj < kPreRows / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 8 * jj + 2 * tig + c, t = rblk * kPreRows + r;
            if (t < T) {
              const float f = row_scales[wg][r];
              __nv_bfloat16* o = out + static_cast<long>(t) * N + n;
              o[0] = __float2bfloat16_rn(__fmul_rn(tot[4 * jj + c], f));
              o[8] = __float2bfloat16_rn(__fmul_rn(tot[4 * jj + 2 + c], f));
            }
          }
      }
      asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = 0.0f;
      j = 0;
      u += ctas;
    }
  }
  hopper::wgmma_wait<0>();
}
"""
# the same without `total`: the epilogue takes the partial as the total,
# exact where K is one k-block; what the halves give once they fit in the
# registers
_PREFILL_HALVES_NOTOT = _PREFILL_HALVES
for _old, _new in [
        ("  float part[64], tot[64], sc[2][2];", "  float part[64], sc[2][2];"),
        ("  for (int i = 0; i < 64; ++i) part[i] = tot[i] = 0.0f;",
         "  for (int i = 0; i < 64; ++i) part[i] = 0.0f;"),
        ("        if (--kleft == 0) {\n#pragma unroll\n          for (int i = 0; i < 64; ++i) {\n"
         "            tot[i] = __fadd_rn(tot[i], part[i]);\n            part[i] = 0.0f;\n"
         "          }\n          kleft = gb;\n        }\n", ""),
        ("tot[4 * jj + c]", "part[4 * jj + c]"), ("tot[4 * jj + 2 + c]", "part[4 * jj + 2 + c]"),
        ("      for (int i = 0; i < 64; ++i) tot[i] = 0.0f;",
         "      for (int i = 0; i < 64; ++i) part[i] = 0.0f;")]:
    assert _old in _PREFILL_HALVES_NOTOT, _old
    _PREFILL_HALVES_NOTOT = _PREFILL_HALVES_NOTOT.replace(_old, _new)
PREFILL_DIAGNOSTICS = {
    "nocompute": [
        ("    for (int gi = 0; gi < kPreSG; ++gi) {\n      // group gi, widened",
         "    for (int gi = 0; gi < (slot < 0 ? kPreSG : 0); ++gi) {\n      // group gi, widened")],
    # the producer fills the ring once, then releases each stage without
    # copies: the consumers' products, flush and epilogue alone
    "noload": [
        ("        weights(q);\n        codes(q);\n      }\n    }\n    return;\n  }\n\n"
         "  asm volatile(\"setmaxnreg.inc",
         "        hopper::mbar_arrive(&full[q.slot]);\n      }\n    }\n    return;\n  }\n\n"
         "  asm volatile(\"setmaxnreg.inc")],
    "nomma": [("      for (int s = 0; s < 4; ++s) wgmma_rs(acc, a[s], db + 2 * s, s);",
               "      if (db == 1) wgmma_rs(acc, a[0], db, 0);")],
    "noflush": [
        ("        for (int i = 0; i < 64; ++i)\n          part[i] = __fadd_rn(part[i], "
         "__fmul_rn(__int2float_rn(acc[i]), (i & 2) ? s1 : s0));",
         "        part[0] = __fadd_rn(part[0], __fmul_rn(__int2float_rn(acc[0]), s0));")],
    # the flush of half the outputs, and the flush without the conversion
    "flushhalf": [
        ("        for (int i = 0; i < 64; ++i)\n          part[i] = __fadd_rn(part[i], "
         "__fmul_rn(__int2float_rn(acc[i]), (i & 2) ? s1 : s0));",
         "        for (int i = 0; i < 32; ++i)\n          part[i] = __fadd_rn(part[i], "
         "__fmul_rn(__int2float_rn(acc[i]), (i & 2) ? s1 : s0));")],
    "noconv": [
        ("__fmul_rn(__int2float_rn(acc[i]), (i & 2) ? s1 : s0)",
         "__fmul_rn(__int_as_float(acc[i]), (i & 2) ? s1 : s0)")],
    # exact: the conversion as an integer add into a float's mantissa and a
    # float subtraction (16 |d| < 2^22) instead of cvt.rn.f32.s32
    "magic": [
        ("__fmul_rn(__int2float_rn(acc[i]), (i & 2) ? s1 : s0)",
         "__fmul_rn(__fsub_rn(__int_as_float(acc[i] + 0x4B400000), 12582912.0f), "
         "(i & 2) ? s1 : s0)")],
    # exact: the warpgroups take turns on the tensor cores through named
    # barriers 3 and 4, each issuing once the other's first two k-steps of
    # a group are done
    "turns": [
        ("  int slot = 0, pass = 0, j = 0, u = static_cast<int>(blockIdx.x), kleft = gb;\n",
         "  int slot = 0, pass = 0, j = 0, u = static_cast<int>(blockIdx.x), kleft = gb;\n"
         "  if (wg == 1) asm volatile(\"bar.arrive 3, 256;\\n\" ::: \"memory\");\n"),
        ("      hopper::wgmma_fence();\n#pragma unroll\n"
         "      for (int s = 0; s < 4; ++s) wgmma_rs(acc, a[s], db + 2 * s, s);\n"
         "      hopper::wgmma_commit();\n      hopper::wgmma_wait<0>();\n",
         "      asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(3 + wg) : \"memory\");\n"
         "      hopper::wgmma_fence();\n#pragma unroll\n"
         "      for (int s = 0; s < 4; ++s) {\n"
         "        wgmma_rs(acc, a[s], db + 2 * s, s);\n"
         "        if (s % 2) hopper::wgmma_commit();\n      }\n"
         "      hopper::wgmma_wait<1>();\n"
         "      if (wg == 0 || k + 1 < total || gi + 1 < kPreSG)\n"
         "        asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(4 - wg) : \"memory\");\n"
         "      hopper::wgmma_wait<0>();\n")],
    "halves": [
        ("  int acc[64];\n  uint32_t a[4][4];\n  float part[64], tot[64];\n",
         "      j = 0;\n      u += ctas;\n    }\n  }\n}\n", _PREFILL_HALVES)],
    "halvesnotot": [
        ("  int acc[64];\n  uint32_t a[4][4];\n  float part[64], tot[64];\n",
         "      j = 0;\n      u += ctas;\n    }\n  }\n}\n", _PREFILL_HALVES_NOTOT)],
    # exact where K is one k-block (see _PREFILL_INFLIGHT2)
    "inflight2": [
        ("  int acc[64];\n  uint32_t a[4][4];\n  float part[64], tot[64];\n",
         "      j = 0;\n      u += ctas;\n    }\n  }\n}\n", _PREFILL_INFLIGHT2)],
}
for _sg in (1, 2, 3, 4):
    PREFILL_DIAGNOSTICS[f"sg{_sg}"] = [
        ("constexpr int kPreSG = 4;", f"constexpr int kPreSG = {_sg};"),
        ("constexpr int kPreSBytes = 2048;",
         f"constexpr int kPreSBytes = {-(-_sg * 512 // 1024) * 1024};")]
REGIMES = {
    "decode": dict(diagnostics=DIAGNOSTICS, entry="lavida_w4_grouped_decode",
                   shapes="128x4096x4096,128x4096x12288", copies=8,
                   variants="base,nocodes,noweights,nomma,noflush,nocompute,timeline"),
    "prefill": dict(diagnostics=PREFILL_DIAGNOSTICS, entry="lavida_w4_grouped",
                    shapes="4608x4096x4096", copies=1,
                    variants="base,nocompute,noload,nomma,noflush"),
}


def _build(out_dir, edits):
    from lavida_mod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    shutil.copytree(os.path.join(HERE, "csrc"), out_dir)
    src = os.path.join(out_dir, "w4_grouped.cu")
    if edits:
        text = open(src).read()
        for edit in edits:
            for old in edit[:-1]:
                if old not in text:
                    raise RuntimeError(f"{out_dir}: no {old!r} to edit")
            if len(edit) == 2:     # (text, replacement)
                text = text.replace(*edit)
            else:                  # (first, last, replacement of first..last)
                a = text.index(edit[0])
                b = text.index(edit[1], a) + len(edit[1])
                text = text[:a] + edit[2] + text[b:]
        open(src, "w").write(text)
    lib = os.path.join(out_dir, "lib.so")
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--regime", choices=sorted(REGIMES), default="decode")
    ap.add_argument("--variants")
    ap.add_argument("--shapes")
    ap.add_argument("--copies", type=int)
    args = ap.parse_args(argv)
    regime = REGIMES[args.regime]
    for key in ("variants", "shapes", "copies"):
        if getattr(args, key) is None:
            setattr(args, key, regime[key])
    diagnostics = regime["diagnostics"]
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from lavida_mod_tpu_torch import kernels
    from lavida_mod_tpu_torch.kernel_times import cuda_ms
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_grouped as tg
    from lavida_mod_tpu_torch.ops.w8a8 import ACT_FORMULA_W4_RECIP, act_quant

    if not torch.cuda.is_available():
        raise RuntimeError("w4_grouped_variants.py needs a CUDA device")
    variants = args.variants.split(",")
    for v in variants:
        for part in v.split("+"):
            if part != "base" and part not in diagnostics and not (
                    args.regime == "decode"
                    and re.fullmatch(r"rb(16|32|48|64)", part)):
                raise ValueError(f"unknown variant {v!r}")
    kernels.library()
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {v: _build(os.path.join(tmp, v), [
            e for part in v.split("+") for e in diagnostics.get(part, [])])
            for v in variants}
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for v, (lib, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(f"[variants] {v}: nvcc failed, left out:\n{log[-3000:]}")
                continue
            if args.regime == "decode":
                regs = re.findall(r"w4_decode_kernelILi(\d+)E[^']*'[\s\S]*?"
                                  r"Used (\d+) registers", log)
                print(f"[variants] {v}: ptxas registers by rb {regs}")
            else:
                m = re.search(r"Compiling entry function '[^']*w4_prefill_kernel"
                              r"[^']*' for 'sm_90a'\n([\s\S]*?Used \d+ "
                              r"registers[^\n]*)", log)
                print(f"[variants] {v}: ptxas {' '.join(m[1].split()) if m else '?'}")
            so = ctypes.CDLL(lib)
            fn = getattr(so, regime["entry"])
            fn.argtypes = [vp] * 5 + [ci] * 9 + [vp]
            fn.restype = ci
            fn.so = so
            fns[v] = fn
        run_shapes(torch, tq, tg, act_quant, ACT_FORMULA_W4_RECIP, cuda_ms,
                   fns, args)


def _plan_args(tg, regime, v, T, Np, sms):
    """The plan's arguments of the regime's entry point, after T, K, N, gb."""
    if regime == "prefill":
        p = tg.prefill_plan(T, Np, sms)
        m = next(filter(None, (re.fullmatch(r"sg(\d+)", part)
                               for part in v.split("+"))), None)
        if m:   # another stage size: as many stages as shared memory holds
            sg = int(m[1])
            stage = ((16 * 512 + tg.PREFILL_ROWS * 128) * sg
                     + -(-sg * 512 // 1024) * 1024)
            stages = min(tg.PREFILL_MAX_STAGES, (tg.SMEM_LIMIT - 2048) // stage)
            p = p._replace(stages=stages, smem=1024 + stages * stage)
        return p, (p.col_tiles, p.row_blocks, p.ctas, p.stages, p.smem)
    p = (tg.decode_layout(T, Np, sms, int(v[2:])) if v.startswith("rb")
         else tg.decode_plan(T, Np, sms))
    return p, (p.rb, p.row_blocks, p.ctas, p.stages, p.smem)


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
        aq = [cuda_ms(lambda: act_quant(x, formula)) for _ in range(2)]
        print(f"[variants] {shape}: the row quantization alone "
              f"{' / '.join(f'{ms:.4f}' for ms in aq)} ms per call")
        gb = tg.groups_per_kblock(K)
        calls = {}
        for v, fn in fns.items():
            p, plan = _plan_args(tg, args.regime, v, T, Np, sms)
            print(f"[variants] {v} {shape}: {p}")
            out = torch.zeros(T, Np, dtype=torch.bfloat16, device=dev)
            it = iter(range(1 << 62))

            def call(fn=fn, out=out, it=it, plan=plan, v=v):
                pk, sc = weights[next(it) % len(weights)]
                x8, sx = act_quant(x, formula)
                err = fn(x8.data_ptr(), sx.data_ptr(), pk.data_ptr(),
                         sc.data_ptr(), out.data_ptr(), T, K, Np, gb, *plan,
                         stream)
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
