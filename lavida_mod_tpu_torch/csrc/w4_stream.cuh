// A weight-streaming grouped-int4 GEMM core for Hopper (sm_90a): 32 rows
// of int8 activation codes against int4 weights in the fragment layout of
// ops/quant.py ([N/8, K/128, 512]), exact int32 group dots flushed into f32
// as acc + d_g * s_g, group by group in order.  Used by the GEMMs of
// w4_qkv_norm and w4_matmul_res and both GEMMs of w4_ffn_fused
// (w4_fused.cu), each with its own stage shape (groups per stage SG, units
// per pass PU).
//
// What bounds it: the weight bytes.  At the decode shapes (32 rows) the
// int8 work is a fifth of the time the weights take to stream, so the
// design keeps the memory system busy and nothing else in the way:
//   - Persistent CTAs, about one per SM, each owning a contiguous run of
//     column units (an n8 tile, or the matching up and gate tiles).  CTA c
//     owns units [c * units / ctas, (c + 1) * units / ctas) and walks them
//     in passes of up to PU units.
//   - One producer warp keeps a ring of `stages` stages in dynamic shared
//     memory filled with 1D bulk copies (`cp.async.bulk`, mbarriers): a
//     tile's K run is contiguous in the fragment layout, so one copy brings
//     SG groups of one tile and no tensor map is needed.  On the H100 a
//     bulk copy costs about as much as 1-2 KB of bandwidth whatever its
//     size, so a stage is few, large copies: one per tile (SG * 512 bytes)
//     and one for the K-slice of the activation codes.  The lanes of the
//     producer warp issue a stage's copies in parallel.
//   - The activation codes come in a "slice layout" that the row passes
//     write: K cut into slices of SG groups, each slice one contiguous
//     [32, ng * 128 + 16] block, so one copy brings a slice with its rows
//     padded by 16 bytes and the ldmatrix fragment loads are
//     conflict-free.
//   - The group scales of the CTA's units (all K) are read once, at the
//     start, by the consumer warps into shared memory, pre-multiplied by
//     1/16 (exact: a power of two).
//   - Eight consumer warps: warp w takes m16 tile (w & 1) and every fourth
//     unit of each pass from (w >> 1), so each A fragment it loads serves
//     all its units.  `mma.sync.m16n8k32.s8` on nibbles widened in two
//     instructions ((w << 4) & 0xF0F0F0F0, w & 0xF0F0F0F0: 16 x the signed
//     codes); the exact int32 sum d = 16 x dot converts to f32 exactly, and
//     f32(d) * (s / 16) is the same rounding of the same real number as
//     dot * s, so the flush is acc + dot * s as the plain version has it.
//   - Programmatic dependent launch: the producer issues its first stages'
//     weights, and the consumers read the scales, before
//     `griddepcontrol.wait`, so both overlap the kernel before; the
//     activation codes and row scales are touched only after the wait.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace w4s {

constexpr int kGroup = 128;
constexpr int kRows = 32;            // rows per launch: two m16 tiles
constexpr int kPad = 16;             // bytes after each row of an A slice
constexpr int kConsumerWarps = 8;
constexpr int kClasses = kConsumerWarps / 2;   // consumer warps per m16 tile
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kMaxStages = 6;
constexpr int kBarBytes = 128;       // 2 * kMaxStages mbarriers
constexpr int kChains = 2;           // independent mma accumulators per tile and group
constexpr int kScaleBatch = 8;       // scale loads in flight per consumer thread

// Byte offset of (row, col) in the slice layout of a [32, G * 128] block
// of codes cut into slices of `sg` groups.
__host__ __device__ inline long slice_offset(int row, int col, int sg, int G) {
  const int j = col / (sg * kGroup);
  const int ng = G - j * sg < sg ? G - j * sg : sg;
  return static_cast<long>(j) * kRows * (sg * kGroup + kPad) +
         static_cast<long>(row) * (ng * kGroup + kPad) + (col - j * sg * kGroup);
}

__host__ __device__ inline long slice_bytes(int sg, int G) {
  return static_cast<long>(kRows) * (G * kGroup + kPad * ((G + sg - 1) / sg));
}

struct Stream {
  const int8_t* a;           // activation codes, slice layout (SG), 32 rows
  const uint8_t* packed;     // [N/8, G, 512] fragment layout
  const float* scales;       // [G, N]
  int G, N;
  int units;                 // column units
  int pair;                  // tiles from a unit's first tile to its second (NT == 2)
  int stages;
  int max_units;             // units of the largest CTA: ceil(units / ctas)
};

template <int NT, int SG, int PU>
struct Layout {
  static constexpr int kASlice = kRows * (SG * kGroup + kPad);
  static constexpr int kStage = kASlice + PU * NT * SG * 512;
  // bars | scales [G][NT][max_units][8] f32 | ring
  __host__ __device__ static long scale_bytes(int G, int max_units) {
    return static_cast<long>(G) * NT * max_units * 32;
  }
  __host__ __device__ static long smem(int G, int max_units, int stages) {
    return kBarBytes + scale_bytes(G, max_units) + static_cast<long>(stages) * kStage;
  }
};

// mbarrier wait that traps after about 2^34 cycles (seconds): a lost
// phase fails the launch with an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (+)= a * b; not volatile: a pure register operation the compiler may
// interleave.  kFirst starts the sum at zero.
template <bool kFirst>
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  if constexpr (kFirst) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// The GEMM of one CTA.  `epi.unit(u, m, acc)` receives the f32 sums of
// unit u (acc[t][e]: tile t, C fragment element e of m16 tile m) once its
// whole K is flushed; `epi.finish(m)` runs once per consumer warp at the
// end, with every lane of the warp.
template <int NT, int SG, int PU, class Epi>
__device__ __forceinline__ void stream_gemm(const Stream& p, uint8_t* smem, Epi& epi) {
  using L = Layout<NT, SG, PU>;
  constexpr int kUnitsPerWarp = PU / kClasses;
  static_assert(PU % kClasses == 0, "a pass's units split evenly over the warps");
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* sS = reinterpret_cast<float*>(smem + kBarBytes);
  uint8_t* ring = smem + kBarBytes + L::scale_bytes(p.G, p.max_units);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u0 = static_cast<int>(static_cast<long>(blockIdx.x) * p.units / gridDim.x);
  const int u1 = static_cast<int>(static_cast<long>(blockIdx.x + 1) * p.units / gridDim.x);
  const int nslices = (p.G + SG - 1) / SG;
  const int total = (u1 - u0 + PU - 1) / PU * nslices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {   // the producer warp
    // lane 0 arms a stage's barrier; the lanes then issue its copies in
    // parallel: lane c the tile copy c, the last lane the codes' slice
    auto arm = [&](int k) {
      const int ub = u0 + k / nslices * PU, nu = min(PU, u1 - ub);
      const int ng = min(SG, p.G - k % nslices * SG);
      if (lane == 0)
        hopper::mbar_expect_tx(&full[k % p.stages],
                               kRows * (ng * kGroup + kPad) + nu * NT * ng * 512);
      __syncwarp();
    };
    auto load_weights = [&](int k) {
      const int ub = u0 + k / nslices * PU, nu = min(PU, u1 - ub);
      const int g0 = k % nslices * SG, ng = min(SG, p.G - g0);
      uint8_t* st = ring + static_cast<long>(k % p.stages) * L::kStage + L::kASlice;
      for (int c = lane; c < nu * NT; c += 32) {
        const int u = c / NT, t = c % NT;
        hopper::bulk_load_1d(st + c * SG * 512,
                             p.packed + (static_cast<long>(ub + u + t * p.pair) * p.G + g0) * 512,
                             ng * 512, &full[k % p.stages]);
      }
    };
    auto load_a = [&](int k) {
      const int j = k % nslices, ng = min(SG, p.G - j * SG);
      if (lane == 31)
        hopper::bulk_load_1d(ring + static_cast<long>(k % p.stages) * L::kStage,
                             p.a + slice_offset(0, j * SG * kGroup, SG, p.G),
                             kRows * (ng * kGroup + kPad), &full[k % p.stages]);
    };
    const int pro = min(p.stages, total);
    for (int k = 0; k < pro; ++k) {   // independent of the kernel before
      arm(k);
      load_weights(k);
    }
    hopper::griddep_wait();
    for (int k = 0; k < pro; ++k) load_a(k);
    for (int k = pro; k < total; ++k) {
      if (lane == 0) bar_wait(&empty[k % p.stages], (k / p.stages - 1) & 1);
      __syncwarp();
      arm(k);
      load_weights(k);
      load_a(k);
    }
    return;
  }

  // consumers: the CTA's scales / 16 into sS[g][t][u - u0][8], 16 bytes a
  // thread at a time, kScaleBatch loads in flight before the first store
  {
    const int nu = u1 - u0, per_group = NT * nu * 2, n = p.G * per_group;
    auto src = [&](int c) {
      const int g = c / per_group, t = c % per_group / (nu * 2), q = c % (nu * 2);
      return reinterpret_cast<const float4*>(p.scales + static_cast<long>(g) * p.N +
                                             (u0 + t * p.pair) * 8) + q;
    };
    auto dst = [&](int c) {
      const int g = c / per_group, t = c % per_group / (nu * 2), q = c % (nu * 2);
      return reinterpret_cast<float4*>(sS + (static_cast<long>(g) * NT + t) * p.max_units * 8) + q;
    };
    for (int c0 = threadIdx.x; c0 < n; c0 += kScaleBatch * kConsumerWarps * 32) {
      float4 v[kScaleBatch];
#pragma unroll
      for (int b = 0; b < kScaleBatch; ++b) {
        const int c = c0 + b * kConsumerWarps * 32;
        if (c < n) v[b] = __ldg(src(c));
      }
#pragma unroll
      for (int b = 0; b < kScaleBatch; ++b) {
        const int c = c0 + b * kConsumerWarps * 32;
        if (c < n)
          *dst(c) = make_float4(v[b].x * 0.0625f, v[b].y * 0.0625f, v[b].z * 0.0625f,
                                v[b].w * 0.0625f);
      }
    }
  }
  consumers_sync();
  hopper::griddep_wait();   // the epilogues read what the kernel before wrote

  // warp w takes m16 tile (w & 1) and units (w >> 1) + kClasses i
  const int m = warp & 1, cls = warp >> 1;
  const int lrow = m * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 16;
  const int tig = lane & 3;
  float acc[kUnitsPerWarp][NT][4];
  // one group of one stage: A fragments once, then every unit's tiles, the
  // products ordered k-step first so that consecutive mma are independent.
  // Units past the pass's last read stale shared memory; their sums are
  // never stored.
  auto group = [&](const uint8_t* W, uint32_t a_addr, int gi, int g, int ul) {
    int a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) ldmatrix_x4(a[s], a_addr + gi * kGroup + s * 32);
    uint4 w[kUnitsPerWarp][NT];
#pragma unroll
    for (int i = 0; i < kUnitsPerWarp; ++i)
#pragma unroll
      for (int t = 0; t < NT; ++t)
        w[i][t] = *reinterpret_cast<const uint4*>(
            W + (((cls + kClasses * i) * NT + t) * SG + gi) * 512 + lane * 16);
    int d[kChains][kUnitsPerWarp][NT][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < kUnitsPerWarp; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint32_t word = s == 0 ? w[i][t].x : s == 1 ? w[i][t].y
                              : s == 2 ? w[i][t].z : w[i][t].w;
          const int b0 = static_cast<int>((word << 4) & 0xF0F0F0F0u);
          const int b1 = static_cast<int>(word & 0xF0F0F0F0u);
          if (s < kChains) mma_s8<true>(d[s % kChains][i][t], a[s], b0, b1);
          else mma_s8<false>(d[s % kChains][i][t], a[s], b0, b1);
        }
#pragma unroll
    for (int i = 0; i < kUnitsPerWarp; ++i)
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // the chains' partial sums are exact int32: their sum is the dot
#pragma unroll
        for (int c = 1; c < kChains; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[0][i][t][e] += d[c][i][t][e];
        const int u = min(ul + cls + kClasses * i, p.max_units - 1);
        const float2 sc = *reinterpret_cast<const float2*>(
            sS + ((static_cast<long>(g) * NT + t) * p.max_units + u) * 8 + tig * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][t][e] = __fadd_rn(acc[i][t][e], __fmul_rn(__int2float_rn(d[0][i][t][e]),
                                                           (e & 1) ? sc.y : sc.x));
      }
  };
  for (int k0 = 0; k0 < total; k0 += nslices) {
    const int ul = k0 / nslices * PU, nu = min(PU, u1 - u0 - ul);
#pragma unroll
    for (int i = 0; i < kUnitsPerWarp; ++i)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.0f;
    for (int j = 0; j < nslices; ++j) {
      const int k = k0 + j, slot = k % p.stages;
      const int ng = min(SG, p.G - j * SG);
      bar_wait(&full[slot], (k / p.stages) & 1);
      const uint8_t* st = ring + static_cast<long>(slot) * L::kStage;
      const uint32_t a_addr = hopper::smem_u32(st + lrow * (ng * kGroup + kPad) + lcol);
      if (ng == SG) {
#pragma unroll
        for (int gi = 0; gi < SG; ++gi) group(st + L::kASlice, a_addr, gi, j * SG + gi, ul);
      } else {
#pragma unroll 1
        for (int gi = 0; gi < ng; ++gi) group(st + L::kASlice, a_addr, gi, j * SG + gi, ul);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    }
#pragma unroll
    for (int i = 0; i < kUnitsPerWarp; ++i)
      if (cls + kClasses * i < nu) epi.unit(u0 + ul + cls + kClasses * i, m, acc[i]);
  }
  epi.finish(m);
}

}  // namespace w4s
