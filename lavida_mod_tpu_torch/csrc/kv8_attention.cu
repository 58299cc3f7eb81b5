// Decode attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/kv8_attention.py::kv8_decode_attention (the
// Pallas kernel of the --kv8 decode): softmax(q k8^T * (k_scale * sm_scale))
// (p * v_scale) v8 over a head-major int8 cache k8/v8 [B, Hkv, S, hd] with
// per-(head, position) scales ks/vs [B, Hkv, 1, S]; masked keys score
// -1e30 (not -inf); the whole key row is softmaxed at once (the TPU holds
// all of S in VMEM); p * v_scale is rounded to bf16 before the PV product;
// query head j*G+g reads KV head j.
//
// What bounds it on the H100: the cache stream.  At B = 4, the bench image
// (S = 1184) and LLaDA-8B's 32 heads of 128, one launch reads 38.8 MB of
// int8 K/V and 1.2 MB of scales: 12 us at 3.35 TB/s; its 2.5 G multiply-adds
// are 5 us of bf16 tensor-core work.
//
// What the design does (simple first): one CTA of 256 threads per (batch,
// query head, 8 query rows).  The 8 query rows are staged in shared memory
// as f32; phase 1 gives each thread whole keys (16-byte loads of the int8
// row) and writes the 8 scaled, masked scores of each key into an f32 score
// block [8, S] in shared memory (37.9 KB at S = 1184); phase 2 softmaxes
// each row in one warp (max, exp, sum, divide, times v_scale, rounded to
// bf16, in place); phase 3 gives each thread one output column d and a
// slice of the keys, reading v8 rows coalesced, and the slices are summed
// through shared memory.  CUDA cores in f32 throughout, no tensor cores:
// K and V are re-read once per 8-row query block (4 times at T = 32, from
// L2 after the first).  The sums run in another order than the TPU's dots,
// so results agree to f32 rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;            // query rows per CTA (one warp each in phase 2)
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;   // kv8_attention.py's NEG_INF

__global__ void __launch_bounds__(kThreads)
kv8_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
           const float* __restrict__ ks, const int8_t* __restrict__ v8,
           const float* __restrict__ vs, const int32_t* __restrict__ valid,
           __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int S, int hd,
           float scale) {
  extern __shared__ float smem[];
  const int nsplit = kThreads / hd;                // key slices in phase 3
  float* sq = smem;                                // [kRows, hd]
  float* sp = sq + kRows * hd;                     // [kRows, S]
  float* spart = sp + static_cast<long>(kRows) * S;   // [nsplit, kRows, hd]

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRows;
  const int nrows = min(kRows, T - t0);
  const int j = h / (H / Hkv);
  const long kvh = static_cast<long>(b) * Hkv + j;
  const int8_t* kb = k8 + kvh * S * hd;
  const int8_t* vb = v8 + kvh * S * hd;
  const float* ksb = ks + kvh * S;
  const float* vsb = vs + kvh * S;

  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    sq[i] = r < nrows
                ? __bfloat162float(q[((static_cast<long>(b) * T + t0 + r) * H + h) * hd + d])
                : 0.0f;
  }
  __syncthreads();

  // phase 1: scores, a thread per key
  for (int s = threadIdx.x; s < S; s += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    const int8_t* kr = kb + static_cast<long>(s) * hd;
    for (int d0 = 0; d0 < hd; d0 += 16) {
      const int4 raw = *reinterpret_cast<const int4*>(kr + d0);
      const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float kf = static_cast<float>(kv[e]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(sq[r * hd + d0 + e], kf, acc[r]);
      }
    }
    const float kcol = __fmul_rn(ksb[s], scale);
    const bool ok = valid == nullptr || valid[static_cast<long>(b) * S + s] != 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      sp[static_cast<long>(r) * S + s] = ok ? __fmul_rn(acc[r], kcol) : kMasked;
  }
  __syncthreads();

  // phase 2: the softmax of row `warp`, then p * v_scale rounded to bf16
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < nrows) {
    float* row = sp + static_cast<long>(warp) * S;
    float m = kMasked;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(__fsub_rn(row[s], m));
      row[s] = p;
      sum = __fadd_rn(sum, p);
    }
    for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    for (int s = lane; s < S; s += 32)
      row[s] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(row[s] / sum, vsb[s])));
  }
  __syncthreads();

  // phase 3: out[r, d] = sum_s pv[r, s] * v8[s, d]; thread (slice, d)
  const int d = threadIdx.x % hd, slice = threadIdx.x / hd;
  if (slice < nsplit) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int s = slice; s < S; s += nsplit) {
      const float vf = static_cast<float>(vb[static_cast<long>(s) * hd + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(sp[static_cast<long>(r) * S + s], vf, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) spart[(slice * kRows + r) * hd + d] = acc[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * hd; i += kThreads) {
    const int r = i / hd, dd = i % hd;
    float v = 0.0f;
    for (int sl = 0; sl < nsplit; ++sl) v = __fadd_rn(v, spart[(sl * kRows + r) * hd + dd]);
    out[((static_cast<long>(b) * T + t0 + r) * H + h) * hd + dd] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// q [B, T, H, hd] bf16; k8, v8 [B, Hkv, S, hd] int8; ks, vs [B, Hkv, 1, S]
// f32; valid [B, S] int32 or null (all keys valid); out [B, T, H, hd]
// bf16.  hd a multiple of 16 dividing 256; H a multiple of Hkv.  Returns a
// cudaError_t.
extern "C" int lavida_kv8_decode_attention(const void* q, const void* k8, const void* ks,
                                           const void* v8, const void* vs, const void* valid,
                                           void* out, int B, int T, int H, int Hkv, int S,
                                           int hd, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || hd <= 0 || hd % 16 || kThreads % hd || Hkv <= 0 ||
      H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * hd + static_cast<size_t>(kRows) * S +
                       static_cast<size_t>(kThreads / hd) * kRows * hd);
  int err = static_cast<int>(cudaFuncSetAttribute(
      kv8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err) return err;
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  kv8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<const int32_t*>(valid),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, S, hd, scale);
  return static_cast<int>(cudaGetLastError());
}
