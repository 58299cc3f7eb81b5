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
// layer) are read from device memory once and from L2 by each of the nine
// 128-row blocks of T.
//
// What the design does about it (section 1 of the Hopper notes): a
// persistent, warp-specialized `wgmma` GEMM.  One CTA per SM walks over
// 128 x 128 output tiles (m fastest, so the CTAs in flight share their
// weight tiles in L2).  A producer warp keeps a four-stage ring of K slices
// in shared memory filled by TMA (128-byte slices of both K-major operands,
// 128-byte swizzle, one `mbarrier` pair per stage); TMA's zero fill covers
// the ragged T, N and K edges.  Two consumer warpgroups each own 64 rows
// and issue `wgmma.m64n128k32.s32.s8.s8` with both operands read from the
// swizzled slices; while they finish one tile's epilogue the producer
// already loads the next tile's slices.  The int32 accumulator never leaves
// the registers: the epilogue applies `(float(acc) * sx[t]) * scale[n]`
// with IEEE multiplies (no contraction) and stores bf16 pairs.  int32
// cannot overflow: 127^2 * 12288 < 2^31.  The two tensor maps are encoded
// on the host (hopper.cuh: `cuTensorMapEncodeTiled` through the runtime's
// driver entry point, so nothing links against libcuda), once per buffer
// and shape, then taken from a cache.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                 // rows of x per tile (2 x 64)
constexpr int kBN = 128;                 // columns of the output per tile
constexpr int kBK = 128;                 // bytes (int8 elements) per K slice
constexpr int kStages = 4;
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + the producer warp

// D (64 x 128, s32) (+)= A (64 x 32 s8, K-major smem) * B (32 x 128 s8,
// K-major smem); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
w8a8_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
            const float* __restrict__ sx, const float* __restrict__ scale,
            __nv_bfloat16* __restrict__ out, int T, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // 128-byte swizzled slices sit on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int m_tiles = (T + kBM - 1) / kBM;
  const int tiles = m_tiles * ((N + kBN - 1) / kBN);
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every TMA load of the ring
    if (threadIdx.x == kConsumers) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * kBM, n0 = (tile / m_tiles) * kBN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(a, &tm_x, &full[stage], kb * kBK, m0);
          tma_load_2d(a + kBM * kBK, &tm_w, &full[stage], kb * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r_in = wg * 64 + warp * 16 + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);                     // and c_in + 1, per 8 columns
  const bool pairs = (N % 2) == 0;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * kBM, n0 = (tile / m_tiles) * kBN;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = smem + stage * kStageBytes;
      const uint64_t da = sw128_desc(a + wg * 64 * kBK);
      const uint64_t db = sw128_desc(a + kBM * kBK);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks) {  // 32-byte steps inside the swizzled row
        wgmma_ss_s8_n128(acc, da + 2 * ks, db + 2 * ks, (kb | ks) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done
      if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + r_in + half * 8;
      if (row >= T) continue;
      const float rs = sx[row];
      __nv_bfloat16* orow = out + static_cast<long>(row) * N;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + j * 8 + c_in;
        if (col >= N) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), rs), scale[col]);
        if (pairs) {  // N even: col + 1 < N, and the pair is 4-byte aligned
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), rs), scale[col + 1]);
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          orow[col] = __float2bfloat16_rn(v0);
          if (col + 1 < N) {
            orow[col + 1] = __float2bfloat16_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), rs), scale[col + 1]));
          }
        }
      }
    }
    fence_acc(acc);
  }
}

// A [rows, K] int8 K-major matrix as 128 x 128-byte boxes, 128-byte swizzle.
bool encode_kmajor(CUtensorMap* map, const void* base, int rows, int K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kBK, 128};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// x8 [T, K] int8, sx [T] f32, w8 [N, K] int8, scale [N] f32, out [T, N]
// bf16; all contiguous, x8 and w8 16-byte aligned, K a multiple of 16.
// Returns a cudaError_t.
extern "C" int lavida_w8a8_matmul(const void* x8, const void* sx, const void* w8,
                                  const void* scale, void* out, int T, int K, int N,
                                  void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_w;
  if (!encode_kmajor(&tm_x, x8, T, K) || !encode_kmajor(&tm_w, w8, N, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = kStages * kStageBytes + 1024;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(w8a8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  const int tiles = ((T + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  w8a8_kernel<<<tiles < sms ? tiles : sms, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<const float*>(sx), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), T, K, N);
  return static_cast<int>(cudaGetLastError());
}
