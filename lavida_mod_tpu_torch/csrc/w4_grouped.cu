// Grouped-int4 W4A8 matmul for Hopper (sm_90a): every LM linear of the
// unfused int4 serving layout (batched prefill and decode).
//
// Replaces: lavida_mod_tpu/ops/pallas_w4.py::w4_matmul_grouped (per-token
// int8 activations times int4 weights with one f32 scale per 128-row group
// and column, bf16 out).  The activation codes come from the row
// quantization kernel of w4_fused.cu (`lavida_act_quant`, formula 2:
// sx = max(amax, 1e-8) * f32(1/127), the TPU wrapper's `/ 127.0` as XLA
// compiles it), as the TPU wrapper quantizes outside its kernel.
//
// The TPU kernel's f32 order, kept bit for bit: inside each k-block of
// `gb` groups (2048 packed rows, 32 groups, at the LLaDA widths) a partial
// sum starts at 0 and takes part + d_g * s_g group by group (d_g the exact
// int32 dot of the group); each finished partial is added to the
// accumulator; the epilogue is bf16(acc * sx).  Multiplies and adds are
// IEEE (__fmul_rn / __fadd_rn): no contraction into FMA.
//
// What bounds it on the H100 (LLaDA-8B, B = 4):
//   - the prefill, T = 4608 rows: 2 * 4608 * 6.98 G = 64.3 T integer ops per
//     batch, 32.5 ms at 1,979 TOP/s -- the int8 tensor cores;
//   - a decode step, T = 128 rows: 3.7 GB of int4 weights and scales,
//     1.1 ms at 3.35 TB/s -- the weight stream.
//
// What the design does (simple first): `mma.sync.m16n8k32.s8` on 64 x 64
// output tiles.  A CTA of 4 warps owns 64 rows and 64 columns; each warp
// owns two n8 column tiles and all four m16 row tiles, so every A fragment
// it loads from shared memory feeds two MMAs.  The weights are in the
// fragment layout of ops/quant.py: one coalesced 16-byte load per lane is
// the B operand of a whole 128-group, and (w << 4) & 0xF0F0F0F0 and
// w & 0xF0F0F0F0 give 16 x the int8 codes (the exact group sum is shifted
// back by 4).  K is walked in slices of 4 groups: the slice's weights are
// loaded to registers first, then the 64-row activation slice is staged in
// shared memory (rows padded by 16 bytes, so the fragment loads are free of
// bank conflicts).  (Loading the next slice's weights one slice ahead, a
// register double buffer, was measured on the H100 at 10-25 % slower on the
// prefill shapes and mixed on the decode ones: it is not kept.)  Ragged T is zero-filled and masked at the store; N is a
// multiple of 64 (the int4 layout pads N to 512).  The w4_fused.cu GEMM
// core takes 32 rows per CTA and one n8 tile per warp: it is the decode
// plan's, sized for T <= 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpTiles = 2;                          // n8 tiles per warp
constexpr int kCtaCols = kWarps * kWarpTiles * 8;      // 64
constexpr int kMTiles = 4;                             // m16 tiles
constexpr int kCtaRows = kMTiles * 16;                 // 64
constexpr int kChunk = 4;                              // groups per slice
constexpr int kRowBytes = kChunk * kGroup + 16;        // padded smem row

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
w4_grouped_kernel(const int8_t* __restrict__ a8, const float* __restrict__ sx,
                  const uint8_t* __restrict__ packed, const float* __restrict__ scales,
                  __nv_bfloat16* __restrict__ out, int T, int K, int N, int gb) {
  __shared__ __align__(16) int8_t sA[kCtaRows * kRowBytes];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.y * kCtaRows;
  const int rows = min(kCtaRows, T - r0);
  const int G = K / kGroup;
  const int tile0 = blockIdx.x * (kWarps * kWarpTiles) + warp * kWarpTiles;

  float total[kWarpTiles][kMTiles][4], part[kWarpTiles][kMTiles][4];
#pragma unroll
  for (int t = 0; t < kWarpTiles; ++t)
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[t][m][e] = part[t][m][e] = 0.0f;

  for (int g0 = 0; g0 < G; g0 += kChunk) {
    const int ng = min(kChunk, G - g0);
    uint4 w[kWarpTiles][kChunk];
#pragma unroll
    for (int t = 0; t < kWarpTiles; ++t)
#pragma unroll
      for (int gi = 0; gi < kChunk; ++gi)
        if (gi < ng)
          w[t][gi] = __ldg(reinterpret_cast<const uint4*>(
                               packed + (static_cast<long>(tile0 + t) * G + g0 + gi) * 512) +
                           lane);
    __syncthreads();   // the previous slice is consumed
    const int per_row = ng * kGroup / 16;
    const long kb = static_cast<long>(g0) * kGroup;
    for (int c = threadIdx.x; c < kCtaRows * per_row; c += kThreads) {
      const int r = c / per_row, kc = (c % per_row) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        v = *reinterpret_cast<const uint4*>(a8 + static_cast<long>(r0 + r) * K + kb + kc);
      *reinterpret_cast<uint4*>(sA + r * kRowBytes + kc) = v;
    }
    __syncthreads();

#pragma unroll
    for (int gi = 0; gi < kChunk; ++gi) {
      if (gi < ng) {
        int acci[kWarpTiles][kMTiles][4];
#pragma unroll
        for (int t = 0; t < kWarpTiles; ++t)
#pragma unroll
          for (int m = 0; m < kMTiles; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acci[t][m][e] = 0;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          int a[kMTiles][4];
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            const int8_t* q = sA + (m * 16 + gid) * kRowBytes + gi * kGroup + s * 32 + tig * 4;
            a[m][0] = lds32(q);
            a[m][1] = lds32(q + 8 * kRowBytes);
            a[m][2] = lds32(q + 16);
            a[m][3] = lds32(q + 8 * kRowBytes + 16);
          }
#pragma unroll
          for (int t = 0; t < kWarpTiles; ++t) {
            const uint32_t word = s == 0 ? w[t][gi].x : s == 1 ? w[t][gi].y
                                : s == 2 ? w[t][gi].z : w[t][gi].w;
            const int b[2] = {static_cast<int>((word << 4) & 0xF0F0F0F0u),
                              static_cast<int>(word & 0xF0F0F0F0u)};
#pragma unroll
            for (int m = 0; m < kMTiles; ++m) mma_s8(acci[t][m], a[m], b);
          }
        }
        const int g = g0 + gi;
#pragma unroll
        for (int t = 0; t < kWarpTiles; ++t) {
          const float2 sc = *reinterpret_cast<const float2*>(
              scales + static_cast<long>(g) * N + (tile0 + t) * 8 + tig * 2);
#pragma unroll
          for (int m = 0; m < kMTiles; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              part[t][m][e] = __fadd_rn(part[t][m][e],
                                        __fmul_rn(__int2float_rn(acci[t][m][e] >> 4),
                                                  (e & 1) ? sc.y : sc.x));
        }
        if ((g + 1) % gb == 0) {   // a k-block is complete: flush its partial
#pragma unroll
          for (int t = 0; t < kWarpTiles; ++t)
#pragma unroll
            for (int m = 0; m < kMTiles; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                total[t][m][e] = __fadd_rn(total[t][m][e], part[t][m][e]);
                part[t][m][e] = 0.0f;
              }
        }
      }
    }
  }

  // C fragment element e of m-tile m: row m*16 + gid (+8 for e >= 2),
  // column tile*8 + tig*2 + (e & 1)
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + gid + half * 8;
      if (r >= rows) continue;
      const long row = r0 + r;
      const float rs = sx[row];
#pragma unroll
      for (int t = 0; t < kWarpTiles; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          out[row * N + (tile0 + t) * 8 + tig * 2 + c] =
              __float2bfloat16_rn(__fmul_rn(total[t][m][half * 2 + c], rs));
    }
  }
}

}  // namespace

// out [T, N] bf16 = bf16(acc * sx) of a8 [T, K] int8 codes with row scales
// sx [T] f32 against the fragment-layout weights packed [N/8, K/128, 512]
// and scales [K/128, N] f32; gb = groups per k-block (the TPU kernel's
// block_k / 64), dividing K/128.  N a multiple of 64.  Returns a
// cudaError_t.
extern "C" int lavida_w4_grouped(const void* a8, const void* sx, const void* packed,
                                 const void* scales, void* out, int T, int K, int N, int gb,
                                 void* stream) {
  if (T <= 0 || K <= 0 || K % kGroup || N <= 0 || N % kCtaCols || gb <= 0 ||
      (K / kGroup) % gb)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / kCtaCols, (T + kCtaRows - 1) / kCtaRows);
  w4_grouped_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a8), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(out), T, K, N, gb);
  return static_cast<int>(cudaGetLastError());
}
