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
// activations 16.8 MB.
//
// What the design does (simple first): three launches per call, the launch
// boundaries standing in for the TPU kernel's sequential F axis.  A row
// kernel writes ln = bf16(LN(x)) [M, D] (f32 statistics); a bf16 GEMM with
// the fc1 epilogue writes h = bf16(gelu_tanh(acc + b1)) [M, F]; the same
// GEMM with the fc2 epilogue writes bf16(x + acc + b2), where acc takes
// each 512-wide F tile's partial product in order, as the TPU's
// accumulator does.  The GEMM is the w8a8_matmul.cu tile in bf16:
// `mma.sync.m16n8k16.bf16` with f32 accumulators on 128 x 128 output tiles,
// 8 warps of 64 x 32, K streamed in 32-element slices through a two-stage
// cp.async ring, both operands K-major (ln / h [M, K] and the nn.Linear
// weights [N, K]), rows padded to 80 bytes so every fragment register is
// one conflict-free 32-bit shared-memory load.  The M, N and K edges (F =
// 4304 is no multiple of 128) are zero-filled by cp.async and masked at the
// store, where the TPU kernel zero-pads.  The intermediates ln and h make
// one round trip through device memory (31 MB at the bench image), which
// the TPU kernel avoids; fusing them is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;                     // bf16 elements per K slice
constexpr int kStride = kBK * 2 + 16;       // padded smem row, bytes
constexpr int kThreads = 256;               // 8 warps: 2 along M x 4 along N
constexpr int kFTile = 512;                 // the TPU kernel's F tile
constexpr int kLnThreads = 256;

enum Epilogue { kFc1 = 0, kFc2 = 1 };

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// One 128 x kBK tile of a K-major [rows, K] bf16 matrix into smem; rows at
// or past `rows` and elements at or past K are zero-filled (K % 8 == 0).
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* src, int row0,
                                          int rows, int k0, int K) {
  for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kThreads) {
    const int r = c / (kBK / 8);
    const int kc = (c % (kBK / 8)) * 8;
    const bool ok = row0 + r < rows && k0 + kc < K;
    const __nv_bfloat16* g = ok ? src + static_cast<long>(row0 + r) * K + k0 + kc : src;
    cp_async16(dst + r * kStride + kc * 2, g, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True): v * 0.5 * (1 + tanh(sqrt(2/pi) * (v + 0.044715 v^3)))
  const float v3 = __fmul_rn(__fmul_rn(v, v), v);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(v, __fmul_rn(0.044715f, v3)));
  return __fmul_rn(v, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// out = a [M, K] @ w [N, K]^T with the fc1 epilogue (h = bf16(gelu(acc + bias)))
// or the fc2 one (bf16(res + acc + bias), acc summed per 512-wide K tile).
template <int kEpi>
__global__ void __launch_bounds__(kThreads)
mlp_gemm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) uint8_t sA[2][kBM * kStride];
  __shared__ __align__(16) uint8_t sB[2][kBN * kStride];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;     // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4][4], total[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e] = 0.0f;

  const int nk = (K + kBK - 1) / kBK;
  load_tile(sA[0], a, m0, M, 0, K);
  load_tile(sB[0], w, n0, N, 0, K);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile(sA[st ^ 1], a, m0, M, (kt + 1) * kBK, K);
      load_tile(sB[st ^ 1], w, n0, N, (kt + 1) * kBK, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* A = sA[st] + (wm * 64) * kStride;
    const uint8_t* B = sB[st] + (wn * 32) * kStride;
#pragma unroll
    for (int ks = 0; ks < kBK * 2; ks += 32) {   // bytes: one k16 step
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = A + (i * 16 + gid) * kStride + ks + tig * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kStride);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = B + (j * 8 + gid) * kStride + ks + tig * 4;
        bfr[j][0] = lds32(p);
        bfr[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
    if (kEpi == kFc2 && ((kt + 1) * kBK % kFTile == 0 || kt + 1 == nk)) {
      // an F tile is complete: add its partial product to the accumulator
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[i][j][e] = __fadd_rn(total[i][j][e], acc[i][j][e]);
            acc[i][j][e] = 0.0f;
          }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + gid + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + j * 8 + tig * 2 + e;
          if (col >= N) continue;
          const long o = static_cast<long>(row) * N + col;
          float v;
          if constexpr (kEpi == kFc1) {
            v = gelu_tanh(__fadd_rn(acc[i][j][half * 2 + e], bf(bias[col])));
          } else {
            v = __fadd_rn(__fadd_rn(bf(res[o]), total[i][j][half * 2 + e]), bf(bias[col]));
          }
          out[o] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

__device__ float block_sum(float v) {
  __shared__ float red[kLnThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kLnThreads / 32; ++i) v = __fadd_rn(v, red[i]);
  __syncthreads();
  return v;
}

// ln [M, D] = bf16(((x - mu) * rsqrt(var + eps)) * gamma + beta), one row per
// CTA, statistics in f32 (population variance).
__global__ void __launch_bounds__(kLnThreads)
layer_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
                  const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ ln, int D,
                  float eps) {
  const __nv_bfloat16* xr = x + static_cast<long>(blockIdx.x) * D;
  float s = 0.0f;
  for (int k = threadIdx.x; k < D; k += kLnThreads) s = __fadd_rn(s, bf(xr[k]));
  const float mu = block_sum(s) / static_cast<float>(D);
  float ss = 0.0f;
  for (int k = threadIdx.x; k < D; k += kLnThreads) {
    const float c = __fsub_rn(bf(xr[k]), mu);
    ss = __fadd_rn(ss, __fmul_rn(c, c));
  }
  const float inv = rsqrtf(__fadd_rn(block_sum(ss) / static_cast<float>(D), eps));
  __nv_bfloat16* lr = ln + static_cast<long>(blockIdx.x) * D;
  for (int k = threadIdx.x; k < D; k += kLnThreads) {
    const float n = __fmul_rn(__fsub_rn(bf(xr[k]), mu), inv);
    lr[k] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(n, bf(gamma[k])), bf(beta[k])));
  }
}

}  // namespace

// out [M, D] = bf16(x + fc2(gelu_tanh(fc1(LN(x)) + b1)) + b2).  x [M, D],
// gamma/beta/b2 [D], w1 [F, D], b1 [F], w2 [D, F] (the nn.Linear layouts),
// all bf16 and contiguous; ln [M, D] and h [M, F] bf16 are scratch.  D and F
// multiples of 8.  Three launches.  Returns a cudaError_t.
extern "C" int lavida_vit_mlp(const void* x, const void* gamma, const void* beta,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              void* ln, void* h, void* out, int M, int D, int F, float eps,
                              void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  layer_norm_kernel<<<M, kLnThreads, 0, st>>>(static_cast<const bf16*>(x),
                                             static_cast<const bf16*>(gamma),
                                             static_cast<const bf16*>(beta),
                                             static_cast<bf16*>(ln), D, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 g1((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mlp_gemm_kernel<kFc1><<<g1, kThreads, 0, st>>>(
      static_cast<const bf16*>(ln), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      nullptr, static_cast<bf16*>(h), M, D, F);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 g2((D + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mlp_gemm_kernel<kFc2><<<g2, kThreads, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, F, D);
  return static_cast<int>(cudaGetLastError());
}
