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
// What the design does about it: one GEMM kernel, three epilogues.  A CTA of
// 4 warps owns 32 output columns (one mma n8 tile per warp; the up|gate pass
// owns the matching up and gate tiles) and up to 32 rows (blockIdx.y takes
// more).  The weights are in the fragment layout of ops/quant.py, so each
// lane's B operands for one 128-group are one coalesced 16-byte load, and
// the nibbles become int8 in two instructions: (w << 4) & 0xF0F0F0F0 and
// w & 0xF0F0F0F0 give 16 x the signed codes, which the exact int32 group sum
// divides back out with a shift.  A 1024-column slice of the activation
// codes (32 rows) is staged in shared memory, rows padded by 16 bytes so the
// fragment loads are conflict-free; the slice's eight groups of weights are
// all loaded before the slice is staged.  Each group's int32 dot
// (`mma.sync.m16n8k32.s8`) is flushed into the f32 accumulator as
// acc + d_g * s_g with IEEE multiply and add, group by group in order: the
// TPU kernel's `_group_dot_acc`, bit for bit.
//
// The RMSNorm and activation quantization run as a pre-pass kernel per row
// (a CTA per row) instead of in every CTA: [32, 4096] re-normalized by 384
// CTAs would cost more than the weights.  `w4_ffn_fused` is two GEMM
// launches with a row pass before each: up|gate with the SwiGLU epilogue
// writes the bf16 [T, H] intermediate (786 KB at 8B, it stays in L2); a
// CTA per row then takes its amax and codes, sa = max(amax, 1e-8) / 127;
// the down GEMM adds the residual in the matmul_res epilogue.  The TPU's
// sequential grid carried the amax from the up phase to the down phase
// inside one kernel; here the launch boundaries are the grid-wide barriers
// (no cooperative launch).  Quantizing the intermediate while staging it in
// each down CTA instead was measured at 0.29 ms per call on the H100, 2.4x
// the whole rest of the FFN: every CTA re-divided all T x H values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCtaCols = kWarps * 8;        // 32 output columns per CTA
constexpr int kRows = 32;                   // rows per CTA: two m16 tiles
constexpr int kChunkGroups = 8;             // groups staged per slice
constexpr int kRowBytes = kChunkGroups * kGroup + 16;   // padded smem row
constexpr int kQuantThreads = 256;

enum Mode { kQkv = 0, kRes = 1, kUpGate = 2 };

struct Gemm {
  const int8_t* a8;             // [T, K] activation codes
  const float* row_scale;       // [T] their per-row scale
  const uint8_t* packed;        // [N/8, K/128, 512] fragment layout
  const float* scales;          // [K/128, N]
  const __nv_bfloat16* res;     // [T, N] residual (kRes)
  __nv_bfloat16* out;           // [T, N]; kUpGate: the intermediate [T, H]
  int T, K, N, H;               // kUpGate: N = 2H
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);   // IEEE /, ties to even
  return static_cast<int8_t>(q);
}

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
//   kind 1: sx = max(amax, 1e-8) / 127      (w4_fused.py:276, w4_matmul_res)
//   kind 2: RMSNorm first -- f32 statistics, x * rsqrt(var + eps) rounded to
//           bf16, times the bf16 weight rounded to bf16 -- then kind 1's
//           formula (w4_fused.py:65-75).
//   kind 3: sx = max(amax, 1e-8) * f32(1/127)  (pallas_w4.py:172 as XLA
//           compiles it: a division by a constant becomes a multiplication
//           by its reciprocal; the grouped W4A8 matmul of w4_grouped.cu)
// q rows are `ldq` >= K bytes apart; columns [K, ldq) are written as 0.
template <int kKind>
__global__ void __launch_bounds__(kQuantThreads)
row_quant_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ norm_w,
                 int8_t* __restrict__ q, float* __restrict__ s, int K, int ldq, float eps) {
  const long row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * K;
  float inv = 0.0f;
  if (kKind == 2) {
    float ss = 0.0f;
    for (int k = threadIdx.x; k < K; k += kQuantThreads) {
      const float f = bf(xr[k]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
    ss = block_reduce<false>(ss);
    inv = rsqrtf(ss / static_cast<float>(K) + eps);
  }
  auto value = [&](int k) {
    const float f = bf(xr[k]);
    if (kKind != 2) return f;
    return round_bf16(__fmul_rn(round_bf16(__fmul_rn(f, inv)), bf(norm_w[k])));
  };
  float mx = 0.0f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) mx = fmaxf(mx, fabsf(value(k)));
  mx = block_reduce<true>(mx);
  const float sc = kKind == 0   ? fmaxf(mx / 127.0f, 1e-8f)
                   : kKind == 3 ? __fmul_rn(fmaxf(mx, 1e-8f), 1.0f / 127.0f)
                                : fmaxf(mx, 1e-8f) / 127.0f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) q[row * ldq + k] = quant(value(k), sc);
  for (int k = K + threadIdx.x; k < ldq; k += kQuantThreads) q[row * ldq + k] = 0;
  if (threadIdx.x == 0) s[row] = sc;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) w4_gemm_kernel(Gemm p) {
  constexpr int NT = kMode == kUpGate ? 2 : 1;   // weight tiles per warp
  __shared__ __align__(16) int8_t sA[kRows * kRowBytes];
  __shared__ float sRow[kRows];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, p.T - r0);
  const int G = p.K / kGroup;
  int tile[NT];
  tile[0] = blockIdx.x * kWarps + warp;
  if constexpr (NT == 2) tile[1] = p.H / 8 + tile[0];   // the matching gate tile

  if (threadIdx.x < kRows)
    sRow[threadIdx.x] = static_cast<int>(threadIdx.x) < rows ? p.row_scale[r0 + threadIdx.x] : 0.0f;

  float accf[NT][2][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) accf[t][m][e] = 0.0f;

  for (int g0 = 0; g0 < G; g0 += kChunkGroups) {
    const int ng = min(kChunkGroups, G - g0);
    uint4 w[NT][kChunkGroups];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int gi = 0; gi < kChunkGroups; ++gi)
        if (gi < ng)
          w[t][gi] = __ldg(reinterpret_cast<const uint4*>(
                               p.packed + (static_cast<long>(tile[t]) * G + g0 + gi) * 512) +
                           lane);
    __syncthreads();   // the previous slice is consumed (and sRow is written)
    const int kb = g0 * kGroup, cb = ng * kGroup;
    for (int c = threadIdx.x; c < kRows * (cb / 16); c += kThreads) {
      const int r = c / (cb / 16), kc = (c % (cb / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        v = *reinterpret_cast<const uint4*>(p.a8 + static_cast<long>(r0 + r) * p.K + kb + kc);
      *reinterpret_cast<uint4*>(sA + r * kRowBytes + kc) = v;
    }
    __syncthreads();

#pragma unroll
    for (int gi = 0; gi < kChunkGroups; ++gi) {
      if (gi < ng) {
        int acci[NT][2][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acci[t][m][e] = 0;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          int a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int8_t* q = sA + (m * 16 + gid) * kRowBytes + gi * kGroup + s * 32 + tig * 4;
            a[m][0] = lds32(q);
            a[m][1] = lds32(q + 8 * kRowBytes);
            a[m][2] = lds32(q + 16);
            a[m][3] = lds32(q + 8 * kRowBytes + 16);
          }
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const uint32_t word = s == 0 ? w[t][gi].x : s == 1 ? w[t][gi].y
                                : s == 2 ? w[t][gi].z : w[t][gi].w;
            const int b[2] = {static_cast<int>((word << 4) & 0xF0F0F0F0u),
                              static_cast<int>(word & 0xF0F0F0F0u)};
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_s8(acci[t][m], a[m], b);
          }
        }
        const int g = g0 + gi;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float2 sc = *reinterpret_cast<const float2*>(
              p.scales + static_cast<long>(g) * p.N + tile[t] * 8 + tig * 2);
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              accf[t][m][e] = __fadd_rn(accf[t][m][e],
                                        __fmul_rn(__int2float_rn(acci[t][m][e] >> 4),
                                                  (e & 1) ? sc.y : sc.x));
        }
      }
    }
  }

  // epilogue: C fragment element e of m-tile m is row m*16 + gid (+8 for
  // e >= 2), column tile*8 + tig*2 + (e & 1)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + gid + half * 8;
      const bool ok = r < rows;
      const long row = r0 + r;
      const float rs = sRow[r];
      if (!ok) continue;
      if constexpr (kMode == kUpGate) {
        // SwiGLU in f32 on the bf16-rounded up and gate, result in bf16
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = half * 2 + c;
          const float u = round_bf16(__fmul_rn(accf[0][m][e], rs));
          const float gt = round_bf16(__fmul_rn(accf[1][m][e], rs));
          const float sig = 1.0f / (1.0f + expf(-gt));
          p.out[row * p.H + tile[0] * 8 + tig * 2 + c] =
              __float2bfloat16_rn(__fmul_rn(__fmul_rn(gt, sig), u));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const long o = row * p.N + tile[0] * 8 + tig * 2 + c;
          float v = __fmul_rn(accf[0][m][half * 2 + c], rs);
          if constexpr (kMode != kQkv) v = __fadd_rn(v, bf(p.res[o]));
          p.out[o] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

template <int kMode>
int launch_gemm(const Gemm& p, int cols, cudaStream_t st) {
  const dim3 grid(cols / kCtaCols, (p.T + kRows - 1) / kRows);
  w4_gemm_kernel<kMode><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_quant(int kind, const void* x, const void* norm_w, void* q, void* s, int T, int K,
                 int ldq, float eps, cudaStream_t st) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(norm_w);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  if (kind == 0) row_quant_kernel<0><<<T, kQuantThreads, 0, st>>>(xp, wp, qp, sp, K, ldq, eps);
  if (kind == 1) row_quant_kernel<1><<<T, kQuantThreads, 0, st>>>(xp, wp, qp, sp, K, ldq, eps);
  if (kind == 2) row_quant_kernel<2><<<T, kQuantThreads, 0, st>>>(xp, wp, qp, sp, K, ldq, eps);
  if (kind == 3) row_quant_kernel<3><<<T, kQuantThreads, 0, st>>>(xp, wp, qp, sp, K, ldq, eps);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Per-token int8 codes x8 [T, K] and scales sx [T] of bf16 x [T, K]
// (formula 0: the W8A8 prefill's, 1: the W4A8 one, 2: the W4A8 one with
// the reciprocal, row kind 3).
extern "C" int lavida_act_quant(const void* x, void* x8, void* sx, int T, int K, int formula,
                                void* stream) {
  if (T <= 0 || K <= 0 || formula < 0 || formula > 2) return kBad;
  return launch_quant(formula == 2 ? 3 : formula, x, nullptr, x8, sx, T, K, K, 0.0f,
                      static_cast<cudaStream_t>(stream));
}

// out [T, N] = bf16(rmsnorm(x) @ W4 * sx); x [T, D] bf16, norm_w [D] bf16,
// packed [N/8, D/128, 512], scales [D/128, N] f32; x8 [T, D] and sx [T]
// are scratch.
extern "C" int lavida_w4_qkv_norm(const void* x, const void* norm_w, const void* packed,
                                  const void* scales, void* x8, void* sx, void* out, int T,
                                  int D, int N, float eps, void* stream) {
  if (T <= 0 || D <= 0 || D % kGroup || N <= 0 || N % kCtaCols) return kBad;
  const auto st = static_cast<cudaStream_t>(stream);
  int err = launch_quant(2, x, norm_w, x8, sx, T, D, D, eps, st);
  if (err) return err;
  Gemm p{};
  p.a8 = static_cast<const int8_t*>(x8);
  p.row_scale = static_cast<const float*>(sx);
  p.packed = static_cast<const uint8_t*>(packed);
  p.scales = static_cast<const float*>(scales);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = T, p.K = D, p.N = N;
  return launch_gemm<kQkv>(p, N, st);
}

// out [T, N] = bf16(a @ W4 * sa + res); a [T, K] bf16, res [T, N] bf16;
// a8 [T, K] and sa [T] are scratch.
extern "C" int lavida_w4_matmul_res(const void* a, const void* res, const void* packed,
                                    const void* scales, void* a8, void* sa, void* out, int T,
                                    int K, int N, void* stream) {
  if (T <= 0 || K <= 0 || K % kGroup || N <= 0 || N % kCtaCols) return kBad;
  const auto st = static_cast<cudaStream_t>(stream);
  int err = launch_quant(1, a, nullptr, a8, sa, T, K, K, 0.0f, st);
  if (err) return err;
  Gemm p{};
  p.a8 = static_cast<const int8_t*>(a8);
  p.row_scale = static_cast<const float*>(sa);
  p.packed = static_cast<const uint8_t*>(packed);
  p.scales = static_cast<const float*>(scales);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = T, p.K = K, p.N = N;
  return launch_gemm<kRes>(p, N, st);
}

// out [T, D] = x + down(swiglu(rmsnorm(x) @ W_up|gate)); up [D -> 2H] (up
// columns first), down [Hd -> D] with Hd >= H.  x8 [T, D], sx [T],
// inter [T, H] bf16, a8 [T, Hd] and sa [T] are scratch.  Four launches:
// the norm pre-pass, up|gate + SwiGLU, the intermediate's row pass, down
// + residual.
extern "C" int lavida_w4_ffn_fused(const void* x, const void* norm_w, const void* up_packed,
                                   const void* up_scales, const void* dn_packed,
                                   const void* dn_scales, void* x8, void* sx, void* inter,
                                   void* a8, void* sa, void* out, int T, int D, int H, int Hd,
                                   float eps, void* stream) {
  if (T <= 0 || D <= 0 || D % kGroup || D % kCtaCols || H <= 0 || H % kCtaCols || Hd < H ||
      Hd % kGroup)
    return kBad;
  const auto st = static_cast<cudaStream_t>(stream);
  int err = launch_quant(2, x, norm_w, x8, sx, T, D, D, eps, st);
  if (err) return err;
  Gemm up{};
  up.a8 = static_cast<const int8_t*>(x8);
  up.row_scale = static_cast<const float*>(sx);
  up.packed = static_cast<const uint8_t*>(up_packed);
  up.scales = static_cast<const float*>(up_scales);
  up.out = static_cast<__nv_bfloat16*>(inter);
  up.T = T, up.K = D, up.N = 2 * H, up.H = H;
  err = launch_gemm<kUpGate>(up, H, st);
  if (err) return err;
  err = launch_quant(1, inter, nullptr, a8, sa, T, H, Hd, 0.0f, st);
  if (err) return err;
  Gemm dn{};
  dn.a8 = static_cast<const int8_t*>(a8);
  dn.row_scale = static_cast<const float*>(sa);
  dn.packed = static_cast<const uint8_t*>(dn_packed);
  dn.scales = static_cast<const float*>(dn_scales);
  dn.res = static_cast<const __nv_bfloat16*>(x);
  dn.out = static_cast<__nv_bfloat16*>(out);
  dn.T = T, dn.K = Hd, dn.N = D;
  return launch_gemm<kRes>(dn, D, st);
}
