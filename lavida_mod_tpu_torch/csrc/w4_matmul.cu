// Per-channel int4 weight matmul (bf16 activations) for Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/pallas_w4.py::w4_matmul (the Pallas TPU
// kernel that unpacks int4 weights in VMEM: x2 [2, T, K/2] bf16 holds the
// even and odd K columns of x, packed [K/2, N] int8 holds row 2k of W in
// the low nibble of byte k and row 2k + 1 in the high one, both signed;
// out = bf16((x_even @ lo + x_odd @ hi) * scale[n]) with f32 dots).  No
// model leaf or serving path of either package builds this layout: the
// int4 layouts use the grouped kernel (w4_grouped.cu).
//
// What bounds it on the H100: at decode widths ([32, 4096] x 12288, the TPU
// status note's shape) the 25 MB of packed weights, 7.6 us at 3.35 TB/s;
// at the prefill's T = 1056 the bf16 tensor cores, 106 G flop, 0.107 ms.
//
// What the design does (simple first): `mma.sync.m16n8k16` bf16 with f32
// accumulators on 32 x 64 output tiles.  A CTA of 4 warps owns 32 rows and
// 64 columns, each warp 16 columns over both m16 row tiles.  K is walked
// in slices of 32 packed rows: the slice's x_even / x_odd rows (bf16) and
// packed bytes are staged in shared memory with plain loads (16-byte ones
// when every row is 16-byte aligned), then each lane reads the four bytes
// of its B fragment, splits each into its two signed nibbles and converts
// them to bf16 (exact), giving the B fragments of the lo and the hi
// product; both products go into one accumulator.  The epilogue is
// bf16(acc * scale[n]) with an IEEE multiply.  Ragged T, N and K are
// zero-filled at the load and masked at the store.  Later work: a cp.async
// ring and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;           // rows of x per CTA
constexpr int kBN = 64;           // columns of W per CTA
constexpr int kBK = 32;           // packed rows (pairs of K) per slice
constexpr int kThreads = 128;
constexpr int kLdX = kBK + 8;     // padded bf16 row of the x tiles
constexpr int kLdP = kBN + 16;    // padded byte row of the packed tile

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) nibbles of two packed bytes as bf16 pairs: the lo pair holds the
// low nibbles of p0 (bits 0-15) and p1, the hi pair their high nibbles.
__device__ __forceinline__ void unpack_pair(int8_t p0, int8_t p1, uint32_t& lo,
                                            uint32_t& hi) {
  const int l0 = static_cast<int8_t>(p0 << 4) >> 4, h0 = p0 >> 4;
  const int l1 = static_cast<int8_t>(p1 << 4) >> 4, h1 = p1 >> 4;
  __nv_bfloat162 vl = __floats2bfloat162_rn(static_cast<float>(l0), static_cast<float>(l1));
  __nv_bfloat162 vh = __floats2bfloat162_rn(static_cast<float>(h0), static_cast<float>(h1));
  lo = *reinterpret_cast<uint32_t*>(&vl);
  hi = *reinterpret_cast<uint32_t*>(&vh);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
w4_matmul_kernel(const __nv_bfloat16* __restrict__ x2, const int8_t* __restrict__ packed,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int T,
                 int K2, int N) {
  __shared__ __align__(16) __nv_bfloat16 sX[2][kBM * kLdX];
  __shared__ __align__(16) int8_t sP[kBK * kLdP];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const long plane = static_cast<long>(T) * K2;  // x2[1] - x2[0]

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K2; k0 += kBK) {
    if (kVec) {
      // x: 2 planes x 32 rows x 4 chunks of 8 bf16; packed: 32 rows x 4
      // chunks of 16 bytes (K2 % 8 == 0 and N % 16 == 0: a chunk is all in
      // range or all out)
      for (int c = threadIdx.x; c < 2 * kBM * (kBK / 8); c += kThreads) {
        const int p = c / (kBM * (kBK / 8)), r = (c / (kBK / 8)) % kBM, kc = (c % (kBK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < T && k0 + kc < K2) {
          v = *reinterpret_cast<const uint4*>(x2 + p * plane + static_cast<long>(m0 + r) * K2 + k0 + kc);
        }
        *reinterpret_cast<uint4*>(&sX[p][r * kLdX + kc]) = v;
      }
      for (int c = threadIdx.x; c < kBK * (kBN / 16); c += kThreads) {
        const int r = c / (kBN / 16), nc = (c % (kBN / 16)) * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < K2 && n0 + nc < N) {
          v = *reinterpret_cast<const uint4*>(packed + static_cast<long>(k0 + r) * N + n0 + nc);
        }
        *reinterpret_cast<uint4*>(&sP[r * kLdP + nc]) = v;
      }
    } else {
      for (int c = threadIdx.x; c < 2 * kBM * kBK; c += kThreads) {
        const int p = c / (kBM * kBK), r = (c / kBK) % kBM, k = c % kBK;
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (m0 + r < T && k0 + k < K2) v = x2[p * plane + static_cast<long>(m0 + r) * K2 + k0 + k];
        sX[p][r * kLdX + k] = v;
      }
      for (int c = threadIdx.x; c < kBK * kBN; c += kThreads) {
        const int r = c / kBN, n = c % kBN;
        sP[r * kLdP + n] = (k0 + r < K2 && n0 + n < N) ? packed[static_cast<long>(k0 + r) * N + n0 + n]
                                                       : static_cast<int8_t>(0);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][2][4];  // [plane][m16 tile]
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* row = &sX[p][(i * 16 + g) * kLdX + kk + 2 * t4];
          a[p][i][0] = lds32(row);
          a[p][i][1] = lds32(row + 8 * kLdX);
          a[p][i][2] = lds32(row + 8);
          a[p][i][3] = lds32(row + 8 * kLdX + 8);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* col = &sP[(kk + 2 * t4) * kLdP + warp * 16 + j * 8 + g];
        uint32_t lo0, hi0, lo1, hi1;
        unpack_pair(col[0], col[kLdP], lo0, hi0);
        unpack_pair(col[8 * kLdP], col[9 * kLdP], lo1, hi1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][j], a[0][i], lo0, lo1);
          mma_16816(acc[i][j], a[1][i], hi0, hi1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + i * 16 + g + half * 8;
      if (row >= T) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + warp * 16 + j * 8 + 2 * t4 + e;
          if (col < N) {
            out[static_cast<long>(row) * N + col] =
                __float2bfloat16_rn(__fmul_rn(acc[i][j][half * 2 + e], scale[col]));
          }
        }
    }
}

}  // namespace

// x2 [2, T, K2] bf16, packed [K2, N] int8, scale [N] f32, out [T, N] bf16,
// all contiguous.  Returns a cudaError_t.
extern "C" int lavida_w4_matmul(const void* x2, const void* packed, const void* scale, void* out,
                                int T, int K2, int N, void* stream) {
  if (T <= 0 || K2 <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = K2 % 8 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const auto* x = static_cast<const __nv_bfloat16*>(x2);
  const auto* p = static_cast<const int8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (vec) {
    w4_matmul_kernel<true><<<grid, kThreads, 0, st>>>(x, p, s, o, T, K2, N);
  } else {
    w4_matmul_kernel<false><<<grid, kThreads, 0, st>>>(x, p, s, o, T, K2, N);
  }
  return static_cast<int>(cudaGetLastError());
}
