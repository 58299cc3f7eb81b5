// Fused W4A8 decode-layer kernels for Hopper (sm_90a), and the per-token
// int8 row quantization they and the W8A8 prefill use.
//
// Replaces: lavida_mod_tpu/ops/w4_fused.py::w4_qkv_norm (RMSNorm -> A8 ->
// grouped-int4 dot -> * sx; also the logits head on ln_f),
// ::w4_matmul_res (A8 of `a` -> int4 dot -> * sa + res) and ::w4_ffn_fused
// (RMSNorm -> A8 -> [up|gate] int4 -> SwiGLU -> A8 -> down int4 -> + x).
//
// What bounds them on the H100: the weight stream.  A decode step runs
// T = 32 rows through 4.0 GB of int4 weights (LLaDA-8B: 32 layers x 108 MB
// + the 259 MB head): 1.2 ms at 3.35 TB/s, against 0.26 ms of int8
// tensor-core work.
//
// All three run on the weight-streaming core of w4_stream.cuh: persistent
// CTAs, one producer warp keeping a ring of 1D bulk copies in flight, the
// activation codes read once per pass in K-slices through the ring, the
// group scales once per CTA, each group's exact int32 dot flushed into the
// f32 accumulator as acc + d_g * s_g with IEEE multiply and add, group by
// group in order: the TPU kernel's `_group_dot_acc`, bit for bit.  A row
// pass before each GEMM quantizes its rows into the GEMM's slice layout,
// one CTA per row; each GEMM is launched with programmatic dependent
// launch, so it fills its weight ring and reads its scales while the row
// pass before it runs.

// #5, w4_qkv_norm: 26.7 MB of int4 weights and scales per call at [32,
// 4096] x 12288 ([q|k|v], 8.0 us at 3.35 TB/s), 275 MB at the head's
// 126464 columns.  Two launches per 32 rows: the norm pass (RMSNorm + A8
// into the slice layout, one CTA per row) and the GEMM with a bf16(acc *
// sx) epilogue.  Its stages are 4 groups of 12 tiles, so that at [q|k|v]
// a CTA's 11-12 tiles take one pass and the codes cross L2 once per CTA.
//
// #6, w4_matmul_res: 8.9 MB of int4 weights and scales per call at [32,
// 4096] x 4096 (the attention output projection, 2.7 us at 3.35 TB/s).
// Two launches per 32 rows: the quant pass (A8 of `a` into the slice
// layout) and the GEMM with a bf16(acc * sa + res) epilogue.  Its stages
// are 8 groups of 4 tiles and a CTA owns whole passes (res_plan): at 4096
// columns 128 CTAs of 4 tiles, whose weights all fit in the ring and are
// in flight before the quant pass ends.

// #7, w4_ffn_fused: 80.7 MB to read per call at [32, 4096], H 12288 (24.1
// us at 3.35 TB/s) against 9.7 GOP of int8 work (4.9 us).  Four launches
// per 32 rows: the norm pass (which also zeroes the intermediate's amax),
// up|gate with the SwiGLU epilogue and the amax as an atomicMax, the
// quant pass (codes only, 384 CTAs at 8B), down with the residual.  The
// TPU's sequential grid carried the amax from the up phase to the down
// phase inside one kernel; here the launch boundaries are the grid-wide
// barriers (no cooperative launch, so nothing guarantees that every CTA
// of one grid is resident).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w4_stream.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kQuantThreads = 256;

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);   // IEEE /, ties to even
  return static_cast<int8_t>(q);
}

template <bool kMax>
__device__ float block_reduce(float v) {
  __shared__ float red[kQuantThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kQuantThreads / 32; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

// Per-token int8 codes of one row per CTA.
//   kind 0: sx = max(amax / 127, 1e-8)      (pallas_w8.py:45, the prefill)
//   kind 1: sx = max(amax, 1e-8) / 127      (w4_fused.py:276, the A8 of
//           w4_matmul_res, which its quant pass computes as well)
//   kind 2: sx = max(amax, 1e-8) * f32(1/127)  (pallas_w4.py:172 as XLA
//           compiles it: a division by a constant becomes a multiplication
//           by its reciprocal; the grouped W4A8 matmul of w4_grouped.cu)
// The decode GEMM of w4_grouped.cu is launched after it with programmatic
// dependent launch and streams its first weights while this pass runs.
template <int kKind>
__global__ void __launch_bounds__(kQuantThreads)
row_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ s, int K) {
  hopper::griddep_launch_dependents();
  // 16-byte loads of 8 values (K a multiple of 8, rows 16-byte aligned),
  // 8-byte stores of codes
  const long row = blockIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * K);
  auto unpack = [](uint4 v, float (&f)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      f[2 * i] = __low2float(h);
      f[2 * i + 1] = __high2float(h);
    }
  };
  float mx = 0.0f;
  for (int c = threadIdx.x; c < K / 8; c += kQuantThreads) {
    float f[8];
    unpack(xv[c], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(f[i]));
  }
  mx = block_reduce<true>(mx);
  const float sc = kKind == 0   ? fmaxf(mx / 127.0f, 1e-8f)
                   : kKind == 2 ? __fmul_rn(fmaxf(mx, 1e-8f), 1.0f / 127.0f)
                                : fmaxf(mx, 1e-8f) / 127.0f;
  uint2* qv = reinterpret_cast<uint2*>(q + row * K);
  for (int c = threadIdx.x; c < K / 8; c += kQuantThreads) {
    float f[8];
    unpack(xv[c], f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quant(f[i], sc))) << (8 * (i % 4));
    qv[c] = make_uint2(w[0], w[1]);
  }
  if (threadIdx.x == 0) s[row] = sc;
}

// ---------------------------------------------------------------------------
// w4_qkv_norm, w4_matmul_res and w4_ffn_fused: launches chained by
// programmatic dependent launch
// ---------------------------------------------------------------------------
// #5's and #6's GEMMs and #7's down GEMM stream single tiles, #7's up|gate
// GEMM pairs of matching up and gate tiles, each with the codes' K-slices
// through the ring.  The plans (CTAs, stages, shared bytes) come from
// ops/w4_fused.py::qkv_plan, ::res_plan and ::ffn_plan and are checked
// against these constants.
constexpr int kQkvSG = 4, kQkvPU = 12;   // groups per stage, units per pass
constexpr int kResSG = 8, kResPU = 4;
constexpr int kUpSG = 8, kUpPU = 4;
constexpr int kDnSG = 8, kDnPU = 4;
constexpr int kSmemLimit = 232448;
constexpr int kQuantCols = 4 * kQuantThreads;   // columns per CTA of the quant pass

// The row pass of row blockIdx.x into the next GEMM's slice layout of
// `sg` groups: with kNorm, RMSNorm + A8 (f32 statistics, x * rsqrt(var +
// eps) rounded to bf16, times the bf16 weight rounded to bf16, then sx =
// max(amax, 1e-8) / 127: w4_fused.py:65-75); without, the A8 of the row as
// it is (sx the same; norm_w and eps unused).  The row is read as 16-byte
// chunks of 8 values; rows past T get zero codes and scale 0.
template <bool kNorm>
__device__ __forceinline__ void row_pass(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ norm_w,
                                         int8_t* __restrict__ x8, float* __restrict__ sx, int T,
                                         int D, int sg, float eps) {
  const int row = blockIdx.x, G = D / kGroup, chunks = D / 8;
  auto store = [&](int c, uint2 codes) {
    *reinterpret_cast<uint2*>(x8 + w4s::slice_offset(row, c * 8, sg, G)) = codes;
  };
  if (row >= T) {
    for (int c = threadIdx.x; c < chunks; c += kQuantThreads) store(c, make_uint2(0u, 0u));
    if (threadIdx.x == 0) sx[row] = 0.0f;
    return;
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<long>(row) * D);
  const uint4* wr = reinterpret_cast<const uint4*>(norm_w);
  auto unpack = [](uint4 v, float (&f)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      f[2 * i] = __low2float(h);
      f[2 * i + 1] = __high2float(h);
    }
  };
  float ss = 0.0f;
  if constexpr (kNorm) {
    for (int c = threadIdx.x; c < chunks; c += kQuantThreads) {
      float f[8];
      unpack(xr[c], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
    }
    ss = block_reduce<false>(ss);
  }
  const float inv = kNorm ? rsqrtf(ss / static_cast<float>(D) + eps) : 0.0f;
  auto values = [&](int c, float (&h)[8]) {
    float f[8], g[8];
    unpack(xr[c], f);
    if constexpr (kNorm) {
      unpack(wr[c], g);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = round_bf16(__fmul_rn(round_bf16(__fmul_rn(f[i], inv)), g[i]));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = f[i];
    }
  };
  float mx = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kQuantThreads) {
    float h[8];
    values(c, h);
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(h[i]));
  }
  mx = block_reduce<true>(mx);
  const float sc = fmaxf(mx, 1e-8f) / 127.0f;
  for (int c = threadIdx.x; c < chunks; c += kQuantThreads) {
    float h[8];
    values(c, h);
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      q[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quant(h[i], sc))) << (8 * (i % 4));
    store(c, make_uint2(q[0], q[1]));
  }
  if (threadIdx.x == 0) sx[row] = sc;
}

// #5's norm pass.
__global__ void __launch_bounds__(kQuantThreads)
qkv_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ norm_w,
                int8_t* __restrict__ x8, float* __restrict__ sx, int T, int D, float eps) {
  hopper::griddep_launch_dependents();   // the GEMM starts streaming weights
  row_pass<true>(x, norm_w, x8, sx, T, D, kQkvSG, eps);
}

// The [q|k|v] and head epilogue: bf16(acc * sx), a column pair per store.
struct QkvEpi {
  const float* row_scale;
  __nv_bfloat16* out;   // [T, N]
  int T, N;

  __device__ void unit(int u, int m, const float (&acc)[1][4]) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + gid + half * 8;
      if (r >= T) continue;
      const float rs = row_scale[r];
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(r) * N + u * 8 + tig * 2) =
          __floats2bfloat162_rn(__fmul_rn(acc[0][half * 2], rs),
                                __fmul_rn(acc[0][half * 2 + 1], rs));
    }
  }
  __device__ void finish(int) {}
};

__global__ void __launch_bounds__(w4s::kThreads, 1)
qkv_kernel(w4s::Stream p, const float* __restrict__ sx, __nv_bfloat16* __restrict__ out, int T) {
  extern __shared__ __align__(128) uint8_t smem[];
  hopper::griddep_launch_dependents();
  QkvEpi epi{sx, out, T, p.N};
  w4s::stream_gemm<1, kQkvSG, kQkvPU>(p, smem, epi);
}

// #7's norm pass; it also zeroes the row's amax, which the up|gate
// epilogue raises with atomicMax.
__global__ void __launch_bounds__(kQuantThreads)
ffn_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ norm_w,
                int8_t* __restrict__ x8, float* __restrict__ sx, float* __restrict__ amax, int T,
                int D, int sg, float eps) {
  hopper::griddep_launch_dependents();   // the up GEMM starts streaming weights
  if (threadIdx.x == 0) amax[blockIdx.x] = 0.0f;
  row_pass<true>(x, norm_w, x8, sx, T, D, sg, eps);
}

// The up|gate epilogue: up and gate rounded to bf16 after * sx, SwiGLU in
// f32 rounded to bf16 (w4_fused.py:397-422), and each row's amax of the
// intermediate raised with atomicMax on the bits of a non-negative f32 (a
// max does not depend on the order, so sa is exact).
struct UpGateEpi {
  const float* row_scale;
  __nv_bfloat16* inter;   // [T, H]
  float* amax;            // [32]
  int T, H;
  float mx[2];

  __device__ void unit(int u, int m, const float (&acc)[2][4]) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + gid + half * 8;
      if (r >= T) continue;
      const float rs = row_scale[r];
      __nv_bfloat16 o[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = half * 2 + c;
        const float up = round_bf16(__fmul_rn(acc[0][e], rs));
        const float gt = round_bf16(__fmul_rn(acc[1][e], rs));
        const float sig = 1.0f / (1.0f + expf(-gt));
        o[c] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(gt, sig), up));
        mx[half] = fmaxf(mx[half], fabsf(bf(o[c])));
      }
      *reinterpret_cast<__nv_bfloat162*>(inter + static_cast<long>(r) * H + u * 8 + tig * 2) =
          __halves2bfloat162(o[0], o[1]);
    }
  }

  __device__ void finish(int m) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = mx[half];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int r = m * 16 + gid + half * 8;
      if (tig == 0 && r < T) atomicMax(reinterpret_cast<int*>(amax + r), __float_as_int(v));
    }
  }
};

// #7's down epilogue and #6's: bf16(acc * sa + res), the residual in f32.
struct ResEpi {
  const float* row_scale;
  const __nv_bfloat16* res;   // [T, N]
  __nv_bfloat16* out;         // [T, N]
  int T, N;

  __device__ void unit(int u, int m, const float (&acc)[1][4]) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + gid + half * 8;
      if (r >= T) continue;
      const float rs = row_scale[r];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const long o = static_cast<long>(r) * N + u * 8 + tig * 2 + c;
        out[o] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(acc[0][half * 2 + c], rs), bf(res[o])));
      }
    }
  }
  __device__ void finish(int) {}
};

// #6's quant pass: the A8 of row blockIdx.x of `a` (w4_fused.py:275-278).
__global__ void __launch_bounds__(kQuantThreads)
res_quant_kernel(const __nv_bfloat16* __restrict__ a, int8_t* __restrict__ a8,
                 float* __restrict__ sa, int T, int K) {
  hopper::griddep_launch_dependents();   // the GEMM starts streaming weights
  row_pass<false>(a, nullptr, a8, sa, T, K, kResSG, 0.0f);
}

__global__ void __launch_bounds__(w4s::kThreads, 1)
res_kernel(w4s::Stream p, const float* __restrict__ sa, const __nv_bfloat16* __restrict__ res,
           __nv_bfloat16* __restrict__ out, int T) {
  extern __shared__ __align__(128) uint8_t smem[];
  hopper::griddep_launch_dependents();
  ResEpi epi{sa, res, out, T, p.N};
  w4s::stream_gemm<1, kResSG, kResPU>(p, smem, epi);
}

__global__ void __launch_bounds__(w4s::kThreads, 1)
ffn_up_kernel(w4s::Stream p, const float* __restrict__ sx, __nv_bfloat16* __restrict__ inter,
              float* __restrict__ amax, int T, int H) {
  extern __shared__ __align__(128) uint8_t smem[];
  hopper::griddep_launch_dependents();
  UpGateEpi epi{sx, inter, amax, T, H, {0.0f, 0.0f}};
  w4s::stream_gemm<2, kUpSG, kUpPU>(p, smem, epi);
}

// The intermediate's A8 pass: sa = max(amax, 1e-8) / 127 from the amax the
// up|gate epilogue left, codes of [T, H] into the down GEMM's slice layout
// (columns [H, Hd) and rows past T as zeros), four columns per thread.
__global__ void __launch_bounds__(kQuantThreads)
ffn_quant_kernel(const __nv_bfloat16* __restrict__ inter, const float* __restrict__ amax,
                 int8_t* __restrict__ a8, float* __restrict__ sa, int T, int H, int G) {
  hopper::griddep_launch_dependents();
  hopper::griddep_wait();
  const int row = blockIdx.y, c0 = blockIdx.x * kQuantCols + threadIdx.x * 4;
  const float sc = fmaxf(amax[row], 1e-8f) / 127.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) sa[row] = row < T ? sc : 0.0f;
  if (c0 >= G * kGroup) return;
  uint32_t word = 0;
  if (row < T && c0 < H) {
    const uint2 v = *reinterpret_cast<const uint2*>(inter + static_cast<long>(row) * H + c0);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    const float f[4] = {__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(quant(f[c], sc))) << (8 * c);
  }
  *reinterpret_cast<uint32_t*>(a8 + w4s::slice_offset(row, c0, kDnSG, G)) = word;
}

__global__ void __launch_bounds__(w4s::kThreads, 1)
ffn_down_kernel(w4s::Stream p, const float* __restrict__ sa,
                const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int T) {
  extern __shared__ __align__(128) uint8_t smem[];
  hopper::griddep_launch_dependents();
  ResEpi epi{sa, res, out, T, p.N};
  w4s::stream_gemm<1, kDnSG, kDnPU>(p, smem, epi);
}

int launch_quant(int kind, const void* x, void* q, void* s, int T, int K, cudaStream_t st) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  if (kind == 0) row_quant_kernel<0><<<T, kQuantThreads, 0, st>>>(xp, qp, sp, K);
  if (kind == 1) row_quant_kernel<1><<<T, kQuantThreads, 0, st>>>(xp, qp, sp, K);
  if (kind == 2) {
    // all shared memory, as the decode GEMM of w4_grouped.cu that follows
    // it wants: the SMs need not change their carveout between the two
    static const cudaError_t carve =
        cudaFuncSetAttribute(row_quant_kernel<2>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (carve != cudaSuccess) return static_cast<int>(carve);
    row_quant_kernel<2><<<T, kQuantThreads, 0, st>>>(xp, qp, sp, K);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Per-token int8 codes x8 [T, K] and scales sx [T] of bf16 x [T, K]
// (formula 0: the W8A8 prefill's, 1: the W4A8 one, 2: the W4A8 one with
// the reciprocal); K a multiple of 8, x 16-byte and x8 8-byte aligned.
extern "C" int lavida_act_quant(const void* x, void* x8, void* sx, int T, int K, int formula,
                                void* stream) {
  if (T <= 0 || K <= 0 || K % 8 || formula < 0 || formula > 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(x8) % 8)
    return kBad;
  return launch_quant(formula, x, x8, sx, T, K, static_cast<cudaStream_t>(stream));
}

// out [T, N] = bf16(rmsnorm(x) @ W4 * sx); x [T, D] bf16, norm_w [D] bf16,
// packed [N/8, D/128, 512], scales [D/128, N] f32.  Scratch: x8, the codes
// of [32, D] in the GEMM's slice layout, and sx [32] f32.  Rows go 32 at a
// time, two launches each: the norm pass, then the GEMM with programmatic
// dependent launch.  The plan (ops/w4_fused.py::qkv_plan): the GEMM's
// CTAs, ring stages and dynamic shared bytes.
extern "C" int lavida_w4_qkv_norm(const void* x, const void* norm_w, const void* packed,
                                  const void* scales, void* x8, void* sx, void* out, int T,
                                  int D, int N, float eps, int ctas, int stages, int smem,
                                  void* stream) {
  using L = w4s::Layout<1, kQkvSG, kQkvPU>;
  const int G = D / kGroup;
  if (T <= 0 || D <= 0 || D % kGroup || N <= 0 || N % 8 || ctas < 1 || ctas > N / 8 ||
      stages < 2 || stages > w4s::kMaxStages)
    return kBad;
  const int max_units = (N / 8 + ctas - 1) / ctas;
  if (smem > kSmemLimit || smem != L::smem(G, max_units, stages)) return kBad;
  static int allowed = 0;
  int err = hopper::allow_smem(qkv_kernel, smem, allowed);
  if (err) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* x8p = static_cast<int8_t*>(x8);
  auto* sxp = static_cast<float*>(sx);
  const w4s::Stream p{x8p, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
                      G, N, N / 8, 0, stages, max_units};
  for (int r0 = 0; r0 < T; r0 += w4s::kRows) {
    const int rows = min(w4s::kRows, T - r0);
    qkv_norm_kernel<<<w4s::kRows, kQuantThreads, 0, st>>>(
        xp + static_cast<long>(r0) * D, static_cast<const __nv_bfloat16*>(norm_w), x8p, sxp, rows,
        D, eps);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    err = hopper::launch_dependent(qkv_kernel, dim3(ctas), dim3(w4s::kThreads), smem, st, p,
                                   sxp, op + static_cast<long>(r0) * N, rows);
    if (err) return err;
  }
  return 0;
}

// out [T, N] = bf16(a @ W4 * sa + res); a [T, K] bf16, res [T, N] bf16,
// packed [N/8, K/128, 512], scales [K/128, N] f32.  Scratch: a8, the codes
// of [32, K] in the GEMM's slice layout, and sa [32] f32.  Rows go 32 at a
// time, two launches each: the quant pass, then the GEMM with programmatic
// dependent launch.  The plan (ops/w4_fused.py::res_plan): the GEMM's
// CTAs, ring stages and dynamic shared bytes.
extern "C" int lavida_w4_matmul_res(const void* a, const void* res, const void* packed,
                                    const void* scales, void* a8, void* sa, void* out, int T,
                                    int K, int N, int ctas, int stages, int smem,
                                    void* stream) {
  using L = w4s::Layout<1, kResSG, kResPU>;
  const int G = K / kGroup;
  if (T <= 0 || K <= 0 || K % kGroup || N <= 0 || N % 8 || ctas < 1 || ctas > N / 8 ||
      stages < 2 || stages > w4s::kMaxStages)
    return kBad;
  const int max_units = (N / 8 + ctas - 1) / ctas;
  if (smem > kSmemLimit || smem != L::smem(G, max_units, stages)) return kBad;
  static int allowed = 0;
  int err = hopper::allow_smem(res_kernel, smem, allowed);
  if (err) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* a8p = static_cast<int8_t*>(a8);
  auto* sap = static_cast<float*>(sa);
  const w4s::Stream p{a8p, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
                      G, N, N / 8, 0, stages, max_units};
  for (int r0 = 0; r0 < T; r0 += w4s::kRows) {
    const int rows = min(w4s::kRows, T - r0);
    res_quant_kernel<<<w4s::kRows, kQuantThreads, 0, st>>>(ap + static_cast<long>(r0) * K, a8p,
                                                           sap, rows, K);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    err = hopper::launch_dependent(res_kernel, dim3(ctas), dim3(w4s::kThreads), smem, st, p,
                                   sap, rp + static_cast<long>(r0) * N,
                                   op + static_cast<long>(r0) * N, rows);
    if (err) return err;
  }
  return 0;
}

// out [T, D] = x + down(swiglu(rmsnorm(x) @ W_up|gate)); up [D -> 2H] (up
// columns first), down [Hd -> D] with Hd >= H.  Scratch: x8 and a8, the
// codes of [32, D] and [32, Hd] in the up and down GEMMs' slice layouts,
// inter [32, H] bf16, sx, amax and sa [32] f32.  Rows go 32 at a time,
// four launches each: the norm pass, up|gate + SwiGLU (+ the amax), the
// quant pass, down + residual; the last three with programmatic dependent
// launch.  The plan (ops/w4_fused.py::ffn_plan): CTAs, ring stages and
// dynamic shared bytes of each GEMM.
extern "C" int lavida_w4_ffn_fused(const void* x, const void* norm_w, const void* up_packed,
                                   const void* up_scales, const void* dn_packed,
                                   const void* dn_scales, void* x8, void* sx, void* amax,
                                   void* inter, void* a8, void* sa, void* out, int T, int D,
                                   int H, int Hd, float eps, int up_ctas, int up_stages,
                                   int up_smem, int dn_ctas, int dn_stages, int dn_smem,
                                   void* stream) {
  using Up = w4s::Layout<2, kUpSG, kUpPU>;
  using Dn = w4s::Layout<1, kDnSG, kDnPU>;
  const int Gu = D / kGroup, Gd = Hd / kGroup;
  if (T <= 0 || D <= 0 || D % kGroup || H <= 0 || H % 8 || Hd < H || Hd % kGroup ||
      up_ctas < 1 || up_ctas > H / 8 || dn_ctas < 1 || dn_ctas > D / 8 || up_stages < 2 ||
      up_stages > w4s::kMaxStages || dn_stages < 2 || dn_stages > w4s::kMaxStages)
    return kBad;
  const int up_max = (H / 8 + up_ctas - 1) / up_ctas, dn_max = (D / 8 + dn_ctas - 1) / dn_ctas;
  if (up_smem > kSmemLimit || dn_smem > kSmemLimit || up_smem != Up::smem(Gu, up_max, up_stages) ||
      dn_smem != Dn::smem(Gd, dn_max, dn_stages))
    return kBad;
  static int up_allowed = 0, dn_allowed = 0;
  int err = hopper::allow_smem(ffn_up_kernel, up_smem, up_allowed);
  if (err) return err;
  err = hopper::allow_smem(ffn_down_kernel, dn_smem, dn_allowed);
  if (err) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* x8p = static_cast<int8_t*>(x8);
  auto* a8p = static_cast<int8_t*>(a8);
  auto* sxp = static_cast<float*>(sx);
  auto* sap = static_cast<float*>(sa);
  auto* amp = static_cast<float*>(amax);
  auto* ip = static_cast<__nv_bfloat16*>(inter);
  const w4s::Stream up{x8p, static_cast<const uint8_t*>(up_packed),
                       static_cast<const float*>(up_scales), Gu, 2 * H, H / 8, H / 8,
                       up_stages, up_max};
  const w4s::Stream dn{a8p, static_cast<const uint8_t*>(dn_packed),
                       static_cast<const float*>(dn_scales), Gd, D, D / 8, 0, dn_stages, dn_max};
  for (int r0 = 0; r0 < T; r0 += w4s::kRows) {
    const int rows = min(w4s::kRows, T - r0);
    const __nv_bfloat16* xr = xp + static_cast<long>(r0) * D;
    ffn_norm_kernel<<<w4s::kRows, kQuantThreads, 0, st>>>(
        xr, static_cast<const __nv_bfloat16*>(norm_w), x8p, sxp, amp, rows, D, kUpSG, eps);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    err = hopper::launch_dependent(ffn_up_kernel, dim3(up_ctas), dim3(w4s::kThreads), up_smem,
                                   st, up, sxp, ip, amp, rows, H);
    if (err) return err;
    err = hopper::launch_dependent(ffn_quant_kernel,
                                   dim3((Gd * kGroup + kQuantCols - 1) / kQuantCols, w4s::kRows),
                                   dim3(kQuantThreads), 0, st, ip, amp, a8p, sap, rows, H, Gd);
    if (err) return err;
    err = hopper::launch_dependent(ffn_down_kernel, dim3(dn_ctas), dim3(w4s::kThreads), dn_smem,
                                   st, dn, sap, xr, op + static_cast<long>(r0) * D, rows);
    if (err) return err;
  }
  return 0;
}
