// W8A8 matmul with the scale epilogue fused, for Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/pallas_w8.py::w8a8_matmul (the Pallas TPU
// kernel of the int8 prefill: `(x8 @ w8)` in int32, then
// `(f32(acc) * sx) * scale` rounded to bf16, the accumulator kept in VMEM).
//
// What bounds it on the H100: the int8 tensor cores.  The prefill's four
// linears per layer at T = 1056 ((K, N) = (4096, 12288), (4096, 4096),
// (4096, 24576), (12288, 4096)) are 461 G integer ops per layer, 14.7 T
// per prefill: 7.5 ms at the card's 1,979 TOP/s.  Their weights (218 MB per
// layer) are read about nine times from L2 (once per 128-row block of T),
// once from device memory.
//
// What the design does about it (simple first, not yet the fast shape of
// section 1 of the Hopper notes): `mma.sync.m16n8k32.s32.s8.s8.s32` on
// 128 x 128 output tiles, 8 warps each owning 64 x 32, K streamed in
// 64-byte slices through a two-stage cp.async ring in shared memory.  Both
// operands are K-major ([T, K] and the port's [N, K] weight layout), so
// every fragment register is one 32-bit shared-memory load; rows are
// padded to 80 bytes, which keeps those loads free of bank conflicts.  The
// int32 accumulator never leaves the registers: the epilogue applies
// `(float(acc) * sx[t]) * scale[n]` with IEEE multiplies (no contraction)
// and writes bf16.  Ragged T, N and K edges are zero-filled by cp.async
// and masked at the store (the TPU kernel pads them to 128).  int32 cannot
// overflow: 127^2 * 12288 < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;              // bytes (int8 elements) per K slice
constexpr int kStride = kBK + 16;    // padded smem row, bytes
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// One 128 x kBK tile of a K-major [rows, K] int8 matrix into smem; rows at
// or past `rows` and bytes at or past K are zero-filled.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int row0, int rows,
                                          int k0, int K) {
  for (int c = threadIdx.x; c < kBM * (kBK / 16); c += kThreads) {
    const int r = c / (kBK / 16);
    const int kc = (c % (kBK / 16)) * 16;
    const bool ok = row0 + r < rows && k0 + kc < K;
    const int8_t* g = ok ? src + static_cast<long>(row0 + r) * K + k0 + kc : src;
    cp_async16(dst + r * kStride + kc, g, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
            const int8_t* __restrict__ w8, const float* __restrict__ scale,
            __nv_bfloat16* __restrict__ out, int T, int K, int N) {
  __shared__ __align__(16) int8_t sA[2][kBM * kStride];
  __shared__ __align__(16) int8_t sB[2][kBN * kStride];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;     // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + kBK - 1) / kBK;
  load_tile(sA[0], x8, m0, T, 0, K);
  load_tile(sB[0], w8, n0, N, 0, K);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile(sA[st ^ 1], x8, m0, T, (kt + 1) * kBK, K);
      load_tile(sB[st ^ 1], w8, n0, N, (kt + 1) * kBK, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = sA[st] + (wm * 64) * kStride;
    const int8_t* B = sB[st] + (wn * 32) * kStride;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      int a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = A + (i * 16 + gid) * kStride + ks + tig * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kStride);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = B + (j * 8 + gid) * kStride + ks + tig * 4;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + gid + half * 8;
      if (row >= T) continue;
      const float rs = sx[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + j * 8 + tig * 2 + e;
          if (col < N) {
            const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), rs),
                                      scale[col]);
            out[static_cast<long>(row) * N + col] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

}  // namespace

// x8 [T, K] int8, sx [T] f32, w8 [N, K] int8, scale [N] f32, out [T, N]
// bf16; all contiguous, x8 and w8 16-byte aligned, K a multiple of 16.
// Returns a cudaError_t.
extern "C" int lavida_w8a8_matmul(const void* x8, const void* sx, const void* w8,
                                  const void* scale, void* out, int T, int K, int N,
                                  void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  w8a8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w8), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), T, K, N);
  return static_cast<int>(cudaGetLastError());
}
