// The SigLIP MLP half-block, x + fc2(gelu_tanh(fc1(LN(x)) + b1)) + b2, for
// Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/vit_mlp.py::fused_vit_mlp (one Pallas kernel
// over (512-row M tiles, 512-wide F tiles): LN of the row tile kept in VMEM,
// per F tile h = bf16(gelu(f32(ln @ W1) + b1)) and acc += f32(h @ W2), the
// epilogue bf16(x + acc + b2)).
//
// What bounds it on the H100: the bf16 tensor cores.  At the bench image
// (M = 3645 rows = 5 views x 729, D = 1152, F = 4304) one call is 4 M D F =
// 72.3 G flops: 73 us at 989 TFLOP/s; its weights are 19.8 MB and its
// activations 16.8 MB.  The TPU kernel's full fusion does not carry over:
// an f32 accumulator of 128 rows at D = 1152 is 590 KB, more than an SM's
// registers and shared memory, so fc2 cannot follow fc1 inside one CTA
// without recomputing fc1 per D slice.  The intermediates ln [M, D] and h
// [M, F] make one round trip through device memory (L2 at the bench image:
// 8.4 + 31.4 MB), about 19 us of traffic that overlaps the products.
//
// What the design does: three launches chained by programmatic dependent
// launch (PDL); each waits (griddepcontrol.wait) before it reads the one
// before's output.
//   1. `layer_norm_kernel`: one warp per row, the row read once into
//      registers with 16-byte loads (D <= 2048; wider rows are read three
//      times), mean and population variance in f32 with warp shuffles,
//      ln = bf16(((x - mu) * rsqrt(var + eps)) * gamma + beta).  It lets
//      fc1 launch at its start.
//   2. and 3. `mlp_gemm_kernel`, one persistent, warp-specialized bf16
//      GEMM with two epilogues: fc1 writes h = bf16(gelu_tanh(acc + b1)),
//      fc2 writes bf16((x + total) + b2), where total takes each 512-wide
//      F tile's partial product in order, as the TPU accumulator and the
//      plain version do (one wait for the products and one add every 8
//      slices; one accumulator for all of F measured 1.3 % faster).  One
//      CTA per SM walks 128 x 128 output tiles, rows fastest (the CTAs in
//      flight share their weight tiles in L2).  A producer warpgroup (one
//      thread issuing, its registers handed to the consumers with
//      setmaxnreg 24 / 240, so 168 at entry: kernels.REGISTERS_AT_ENTRY)
//      keeps a ring of kStages K slices of 64 elements (one 128-byte
//      swizzled row) of both K-major operands (ln / h [M, K] and the
//      nn.Linear weights [N, K]) filled by TMA; it issues the first
//      stages' weight slices before it waits for the launch before.  TMA's
//      zero fill covers the ragged M, N and K edges (M = 3645, F = 4304 =
//      67.25 slices).  Two consumer warpgroups run `wgmma.m64n128k16` from
//      the swizzled slices, one slice's products in flight while the next
//      slice's copies are waited for.  fc1 runs them ping-pong (each owns
//      every other tile, so one's GELU epilogue overlaps the other's
//      products; 15 % faster than splitting its tiles by rows), fc2 splits
//      each tile by rows (`total` fits beside the accumulator).  fc2 stores
//      its block through shared memory and TMA; fc1's threads store their
//      column pairs (each measured faster for its GEMM, by 5 % and 2 %).
// The tile choice against the waves on 132 SMs at the bench image: fc1
// [3645, 1152] x 4304 is 29 x 34 = 986 tiles (7.5 waves); fc2 [3645, 4304]
// x 1152 is 29 x 9 = 261 (1.98 waves; 128 x 192 tiles would be 174, 1.3).
//
// What holds it (NVIDIA H100 80GB HBM3, 700 W, vit_mlp_variants.py): a
// call takes about 0.18 ms, 40 % of its bound: LN 0.010 ms, fc1 0.084, fc2
// 0.087.  The ring alone takes 0.057 (fc1) and 0.080 ms (fc2), the
// consumers alone 0.077 and 0.053: fc2 waits on its copies (7 TB/s of
// slices from L2), fc1 on its consumers.  128 x 256 tiles for fc1 (a
// third fewer bytes per output, the epilogue no longer overlapped) and
// clusters of two CTAs sharing the weight slices by TMA multicast (a
// quarter fewer bytes from L2) were no faster.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "w4_stream.cuh"  // w4s::bar_wait: a lost phase traps instead of holding the card

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;              // rows of a tile: two halves of 64
constexpr int kBN = 128;              // columns of a tile
constexpr int kBK = 64;               // elements of a K slice (128 bytes)
constexpr int kStages = 4;
constexpr int kHalfBytes = 64 * kBK * 2;  // one 64-row half of a slice
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;  // the a slice, then the w slice
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kFTile = 512;           // the TPU kernel's F tile
constexpr int kLnWarps = 8;           // rows per CTA of the LN pass
constexpr int kLnChunks = 8;          // 16-byte chunks a lane holds: D <= 2048

enum Epilogue { kFc1 = 0, kFc2 = 1 };

// fc1 runs ping-pong: a consumer warpgroup owns every other 128 x 128 tile
// of the CTA (both 64-row halves), so one's GELU epilogue overlaps the
// other's products.  fc2 splits each tile by rows (warpgroup wg owns rows
// 64 wg .. 64 wg + 63), so `total` fits beside the accumulator.
template <int kEpi>
constexpr bool kPingPong = kEpi == kFc1;
// fc2 writes its block into shared memory and one thread stores it with
// TMA (full 128-byte lines; the map clips the ragged edges); fc1's threads
// store their pairs of columns, which measured faster for it.
template <int kEpi>
constexpr bool kTmaStore = kEpi == kFc2;

template <int kEpi>
struct Plan {
  static constexpr int kHalves = kPingPong<kEpi> ? 2 : 1;  // 64-row halves a warpgroup computes
  // a warpgroup's output block in bf16, staged for the TMA store: per
  // 64-row half two boxes of 64 columns in 128-byte swizzled rows
  static constexpr int kOutBytes = kTmaStore<kEpi> ? kHalves * 64 * kBN * 2 : 0;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kOutBytes + 1024;
  static constexpr int kReaders = kPingPong<kEpi> ? 4 : 8;  // warps that read a slot
};

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True): v * 0.5 * (1 + tanh(sqrt(2/pi) * (v + 0.044715 v^3)))
  const float v3 = __fmul_rn(__fmul_rn(v, v), v);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(v, __fmul_rn(0.044715f, v3)));
  return __fmul_rn(v, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// Ping-pong turns: named barrier 1 + wg lets warpgroup wg wait on its next
// tile's ring slots (bar.sync by its 128 threads) once the other warpgroup
// has waited on every slot of the tile before (bar.arrive by its 128).  A
// waiter on a slot's fill p must find fill p - 1 complete, or the parity
// wait takes a fill two phases old for the one it waits for.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// Named barrier 3 + wg: the 128 threads of warpgroup wg.
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// TMA store of a box from shared memory, its bulk group, and the waits.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the sources may be written again
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {  // the stores are done
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float2 ldg_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// fc1 (kFc1): out = h [M, N] = bf16(gelu_tanh(a w^T + bias)), a = ln [M, K],
// w = w1 [N, K].  fc2 (kFc2): out [M, N] = bf16((res + total) + bias), a = h
// [M, K], w = w2 [N, K], total summed over the 512-wide K tiles in order.
// N is even.  CTA c takes the tiles c, c + ctas, ...; its k-th slice (tile
// k / nk, K slice k % nk) goes to ring slot k % kStages.
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
mlp_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_out, const bf16* __restrict__ bias,
                const bf16* __restrict__ res, bf16* __restrict__ out, int M, int K, int N) {
  using P = Plan<kEpi>;
  constexpr bool kPP = kPingPong<kEpi>;
  constexpr int kHalves = P::kHalves;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // 128-byte swizzled slices sit on 1024-byte boundaries
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int m_tiles = (M + kBM - 1) / kBM;
  const int tiles = m_tiles * ((N + kBN - 1) / kBN);
  const int nk = (K + kBK - 1) / kBK;
  const int ctas = static_cast<int>(gridDim.x);
  const int my_tiles = (tiles - 1 - static_cast<int>(blockIdx.x)) / ctas + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kReaders);  // lane 0 of each warp that reads the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  griddep_launch_dependents();

  if (threadIdx.x >= kConsumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const int total = my_tiles * nk;
      // slice k's tile origin
      auto origin = [&](int k, int& m0, int& n0) {
        const int t = static_cast<int>(blockIdx.x) + k / nk * ctas;
        m0 = t % m_tiles * kBM;
        n0 = t / m_tiles * kBN;
      };
      const int pro = min(kStages, total);
      for (int k = 0; k < pro; ++k) {  // the weights: independent of the launch before
        int m0, n0;
        origin(k, m0, n0);
        mbar_expect_tx(&full[k], kStageBytes);
        tma_load_2d(ring + k * kStageBytes + kBM * kBK * 2, &tm_w, &full[k], k % nk * kBK, n0);
      }
      griddep_wait();  // ln / h come from the launch before
      for (int k = 0; k < pro; ++k) {
        int m0, n0;
        origin(k, m0, n0);
        tma_load_2d(ring + k * kStageBytes, &tm_a, &full[k], k % nk * kBK, m0);
      }
      int slot = pro % kStages, pass = pro / kStages;
      for (int k = pro; k < total; ++k) {
        int m0, n0;
        origin(k, m0, n0);
        w4s::bar_wait(&empty[slot], (pass - 1) & 1);  // the slot's last slice is read
        unsigned char* st = ring + slot * kStageBytes;
        mbar_expect_tx(&full[slot], kStageBytes);
        tma_load_2d(st, &tm_a, &full[slot], k % nk * kBK, m0);
        tma_load_2d(st + kBM * kBK * 2, &tm_w, &full[slot], k % nk * kBK, n0);
        if (++slot == kStages) slot = 0, ++pass;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  // slices summed into acc before fc2 adds acc to total
  const int group = kEpi == kFc2 ? kFTile / kBK : nk;
  const int a_off = kPP ? 0 : wg * kHalfBytes;  // this warpgroup's 64-row halves of a
  unsigned char* stage_out = ring + kStages * kStageBytes + wg * P::kOutBytes;
  const bool leader = (threadIdx.x & 127) == 0;
  float acc[kHalves][64];
  float total[kEpi == kFc2 ? 64 : 1];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;

  for (int i = kPP ? wg : 0; i < my_tiles; i += kPP ? 2 : 1) {
    const int t = static_cast<int>(blockIdx.x) + i * ctas;
    const int m0 = t % m_tiles * kBM, n0 = t / m_tiles * kBN;
    int slot = i * nk % kStages, pass = i * nk / kStages;
    if constexpr (kEpi == kFc2) {
#pragma unroll
      for (int j = 0; j < 64; ++j) total[j] = 0.0f;
    }
    if (kPP && i > 0) turn_wait(wg);
    for (int g0 = 0; g0 < nk; g0 += group) {
      const int ng = min(group, nk - g0);
      int prev = 0;
      for (int j = 0; j < ng; ++j) {
        w4s::bar_wait(&full[slot], pass & 1);
        const unsigned char* st = ring + slot * kStageBytes;
        const uint64_t db = sw128_desc(st + kBM * kBK * 2);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const uint64_t da = sw128_desc(st + a_off + h * kHalfBytes);
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks)  // 32-byte steps inside the swizzled row
            wgmma_ss<128>(acc[h], da + 2 * ks, db + 2 * ks, (j | ks) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done
        if (j > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = slot;
        if (++slot == kStages) slot = 0, ++pass;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
      if (lane == 0) mbar_arrive(&empty[prev]);
      if constexpr (kEpi == kFc2) {
#pragma unroll
        for (int j = 0; j < 64; ++j) total[j] = __fadd_rn(total[j], acc[0][j]);
      }
    }
    if (kPP && i + 1 < my_tiles) turn_pass(wg);  // the other's next tile

    // this thread's rows: 16 warp + lane / 4 (+ 8) of each 64-row half,
    // its columns 8 j + 2 (lane % 4) (+ 1): accumulator 4 j + 2 r8 + e.
    // Every value is computed from loads clamped into the matrices; the
    // stores skip rows past M and columns past N (the TMA store clips them).
    const int r0 = m0 + (kPP ? 0 : wg * 64);
    const int r_in = r0 + warp * 16 + (lane >> 2);
    const int c_in = n0 + 2 * (lane & 3);
    if constexpr (kTmaStore<kEpi>) {  // the block's last stores have read the staging
      if (leader) bulk_wait_read();
      wg_sync(wg);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c_in + 8 * j;
      const float2 b = ldg_bf16x2(bias + min(col, N - 2));
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          const int row = r_in + h * 64 + r8 * 8;
          const int e = 4 * j + 2 * r8;
          float v0, v1;
          if constexpr (kEpi == kFc1) {
            v0 = gelu_tanh(__fadd_rn(acc[h][e], b.x));
            v1 = gelu_tanh(__fadd_rn(acc[h][e + 1], b.y));
          } else {
            const float2 x =
                ldg_bf16x2(res + static_cast<long>(min(row, M - 1)) * N + min(col, N - 2));
            v0 = __fadd_rn(__fadd_rn(x.x, total[e]), b.x);
            v1 = __fadd_rn(__fadd_rn(x.y, total[e + 1]), b.y);
          }
          if constexpr (kTmaStore<kEpi>) {
            // box j / 8 of half h, row r, 16-byte chunk j % 8 swizzled by r % 8
            const int r = row - r0 - h * 64;
            *reinterpret_cast<__nv_bfloat162*>(
                stage_out + h * 16384 + (j >> 3) * 8192 + r * 128 +
                (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) = __floats2bfloat162_rn(v0, v1);
          } else if (row < M && col < N) {  // N even: col + 1 < N as well
            *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(row) * N + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    if constexpr (kTmaStore<kEpi>) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
      if (leader) {
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            tma_store_2d(&tm_out, stage_out + h * 16384 + b * 8192, n0 + 64 * b, r0 + 64 * h);
        bulk_commit();
      }
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_acc(acc[h]);
    if constexpr (kEpi == kFc2) fence_acc(total);
  }
  if (kTmaStore<kEpi> && leader) bulk_wait();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float sum8(float s, const uint4& u) {
  float f[8];
  unpack8(u, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) s = __fadd_rn(s, f[i]);
  return s;
}

__device__ __forceinline__ float sumsq8(float s, const uint4& u, float mu) {
  float f[8];
  unpack8(u, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float c = __fsub_rn(f[i], mu);
    s = __fadd_rn(s, __fmul_rn(c, c));
  }
  return s;
}

__device__ __forceinline__ uint4 norm8(const uint4& u, const uint4& g, const uint4& b, float mu,
                                       float inv) {
  float f[8], gf[8], bf[8];
  unpack8(u, f);
  unpack8(g, gf);
  unpack8(b, bf);
  uint4 o;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float n = __fmul_rn(__fsub_rn(f[2 * i + e], mu), inv);
      y[e] = __fadd_rn(__fmul_rn(n, gf[2 * i + e]), bf[2 * i + e]);
    }
    p[i] = __floats2bfloat162_rn(y[0], y[1]);
  }
  return o;
}

// ln [M, D] = bf16(((x - mu) * rsqrt(var + eps)) * gamma + beta), one warp
// per row, statistics in f32 (population variance), D a multiple of 8.
// kRegs (D <= 256 kLnChunks): the row is read once and kept in registers;
// otherwise it is read three times.
template <bool kRegs>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, bf16* __restrict__ ln, int M, int D,
                  float eps) {
  griddep_launch_dependents();  // fc1 sets up and loads weight slices meanwhile
  const int row = static_cast<int>(blockIdx.x) * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int n = D / 8;  // 16-byte chunks of the row
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<long>(row) * D);
  const uint4* g = reinterpret_cast<const uint4*>(gamma);
  const uint4* b = reinterpret_cast<const uint4*>(beta);
  uint4* lr = reinterpret_cast<uint4*>(ln + static_cast<long>(row) * D);
  uint4 v[kRegs ? kLnChunks : 1];
  float s = 0.0f;
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kLnChunks; ++i)
      if (lane + 32 * i < n) v[i] = xr[lane + 32 * i];
#pragma unroll
    for (int i = 0; i < kLnChunks; ++i)
      if (lane + 32 * i < n) s = sum8(s, v[i]);
  } else {
    for (int c = lane; c < n; c += 32) s = sum8(s, xr[c]);
  }
  const float mu = warp_sum(s) / static_cast<float>(D);
  float ss = 0.0f;
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kLnChunks; ++i)
      if (lane + 32 * i < n) ss = sumsq8(ss, v[i], mu);
  } else {
    for (int c = lane; c < n; c += 32) ss = sumsq8(ss, xr[c], mu);
  }
  const float inv = rsqrtf(__fadd_rn(warp_sum(ss) / static_cast<float>(D), eps));
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kLnChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < n) lr[c] = norm8(v[i], g[c], b[c], mu, inv);
    }
  } else {
    for (int c = lane; c < n; c += 32) lr[c] = norm8(xr[c], g[c], b[c], mu, inv);
  }
}

// A K-major [rows, K] bf16 matrix as boxes of 64 elements x box_rows rows
// in 128-byte swizzled rows (K % 8 == 0: the row stride is a multiple of 16).
bool encode_kmajor(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// out [M, D] = bf16(x + fc2(gelu_tanh(fc1(LN(x)) + b1)) + b2).  x [M, D],
// gamma/beta/b2 [D], w1 [F, D], b1 [F], w2 [D, F] (the nn.Linear layouts),
// all bf16, contiguous and 16-byte aligned; ln [M, D] and h [M, F] bf16 are
// scratch (each launch's output, read by the next).  D and F multiples of
// 8.  Three launches, the second and third under PDL.  Returns a
// cudaError_t.
extern "C" int lavida_vit_mlp(const void* x, const void* gamma, const void* beta,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              void* ln, void* h, void* out, int M, int D, int F, float eps,
                              void* stream) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8) return kBad;
  for (const void* p : {x, gamma, beta, w1, b1, w2, b2, static_cast<const void*>(ln),
                        static_cast<const void*>(h), static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kBad;
  CUtensorMap tm_ln, tm_w1, tm_h, tm_w2, tm_hout, tm_out;  // *out: the TMA stores' boxes
  using P1 = Plan<kFc1>;
  using P2 = Plan<kFc2>;
  if (!encode_kmajor(&tm_ln, ln, M, D, kBM) || !encode_kmajor(&tm_w1, w1, F, D, kBN) ||
      !encode_kmajor(&tm_h, h, M, F, kBM) || !encode_kmajor(&tm_w2, w2, D, F, kBN) ||
      !encode_kmajor(&tm_hout, h, M, F, 64) || !encode_kmajor(&tm_out, out, M, D, 64))
    return kBad;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mlp_gemm_kernel<kFc1>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, P1::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mlp_gemm_kernel<kFc2>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, P2::kSmem);
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int ln_ctas = (M + kLnWarps - 1) / kLnWarps;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(gamma);
  const auto* bb = static_cast<const bf16*>(beta);
  if (D <= 256 * kLnChunks)
    layer_norm_kernel<true><<<ln_ctas, kLnWarps * 32, 0, st>>>(xb, gb, bb, static_cast<bf16*>(ln),
                                                               M, D, eps);
  else
    layer_norm_kernel<false><<<ln_ctas, kLnWarps * 32, 0, st>>>(xb, gb, bb, static_cast<bf16*>(ln),
                                                                M, D, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int t1 = m_tiles * ((F + kBN - 1) / kBN), t2 = m_tiles * ((D + kBN - 1) / kBN);
  err = launch_dependent(mlp_gemm_kernel<kFc1>, dim3(t1 < sms ? t1 : sms), dim3(kThreads),
                         P1::kSmem, st, tm_ln, tm_w1, tm_hout, static_cast<const bf16*>(b1),
                         static_cast<const bf16*>(nullptr), static_cast<bf16*>(h), M, D, F);
  if (err) return err;
  return launch_dependent(mlp_gemm_kernel<kFc2>, dim3(t2 < sms ? t2 : sms), dim3(kThreads),
                          P2::kSmem, st, tm_h, tm_w2, tm_out, static_cast<const bf16*>(b2), xb,
                          static_cast<bf16*>(out), M, F, D);
}
