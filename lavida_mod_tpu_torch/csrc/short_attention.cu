// Non-causal GQA attention with segment-id masking, for Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/short_attention.py::_short_kernel_call
// (the Pallas TPU kernel behind `short_attention`, reached through
// `attention.flash_attention` for the LLaDA prefill and through
// `vision_attention` for every SigLIP layer).
//
// What it computes (same as the TPU kernel): for every (batch, q-head h)
// o[t] = softmax(q[t] . K^T * scale  masked) @ V, with K/V read from head
// h // G (GQA), a key masked with the finite -1e30 when its segment id
// differs from the query's, f32 scores, probabilities rounded to the input
// type before the PV product, f32 accumulation and o / l at the end.
//
// What bounds it on the H100: at the main shapes (SigLIP 5 x 16 heads x
// 729 x 729, hd 72; LLaDA prefill 32 heads x 1056 x 1088, hd 128) the
// products are tensor-core math on K/V tiles that every query tile copies
// again from L2, and at the SigLIP shape those copies are most of the
// kernel's time.  The TPU kernel keeps a whole [S, hd] K/V head in VMEM and
// takes one single-pass softmax; a 1088 x 128 bf16 K plus V head is 557 KB,
// which does not fit the 227 KB of shared memory a CTA can have.
//
// What the design does about it (section 1 of the Hopper notes, the shape
// of FlashAttention-3): the pipeline of csrc/flash_attention.cuh, shared
// with kernel #10's forward (prefix_flash.cu): a producer warpgroup keeps a
// three-stage TMA ring of 128-key K/V tiles (with the tile's key segment
// ids) in flight, two consumer warpgroups of 64 query rows each issue
// wgmma for S = Q K^T and, with p from registers, for O += P V, S_j together
// with P_{j-1} V_{j-1}, and hand the tensor cores back and forth on named
// barriers; the producer gives its registers away with `setmaxnreg`.  A
// narrow tail box keeps hd = 72 from copying 56 columns of zero fill.
//
// The f32 instance (`lavida_short_attention_f32`): the same function on
// f32 operands, as the Pallas kernel computes it for the JAX package's f32
// training harness (SHIRG-LoRA's tower): both products accumulate in f32
// and p stays f32.  The tensor cores have no f32 product (TF32 keeps 10
// mantissa bits), so this instance is FFMA on the CUDA cores, a simple
// tiled design: a CTA of 256 threads takes 64 query rows of one head, keeps
// them in shared memory, and walks 64-key K/V tiles, each thread holding a
// 4 x 4 block of the score tile (rows ty + 16 i, keys tx + 16 j) and a 4 x
// ceil(hd / 16) block of the output (columns tx + 16 c), with an online
// softmax over the tiles.  Rows are padded to 16 ceil(hd / 16) + 4 floats
// so that the float4 reads of a quarter warp fall in distinct banks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
short_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tt_q,
                       const __grid_constant__ CUtensorMap tt_k,
                       const __grid_constant__ CUtensorMap tt_v,
                       const int32_t* __restrict__ q_seg, const int32_t* __restrict__ kv_seg,
                       __nv_bfloat16* __restrict__ out, int T, int S, int Hq, int Hkv, int hd,
                       float scale_log2) {
  flash_fwd<HDP, false>(&tm_q, &tm_k, &tm_v, &tt_q, &tt_k, &tt_v, q_seg, kv_seg, out, nullptr, T, S,
                        Hq, Hkv, hd, scale_log2);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const int32_t* q_seg,
           const int32_t* kv_seg, void* out, int B, int T, int S, int Hq, int Hkv, int hd,
           float scale, cudaStream_t stream) {
  static_assert(kBM == 128 && kBN == 128, "the tensor maps' boxes are 128 rows");
  constexpr int smem = (1 + 2 * kStages) * Layout<HDP>::kTile + 1024;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(short_attention_kernel<HDP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap maps[6];  // q, k, v: 64-column boxes, then tail boxes
  const void* base[3] = {q, k, v};
  const int rows[3] = {T, S, S}, heads[3] = {Hq, Hkv, Hkv};
  for (int i = 0; i < 3; ++i) {
    if (!encode_tile_maps<HDP>(&maps[i], &maps[3 + i], base[i], B, rows[i], heads[i], hd)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((T + kBM - 1) / kBM, Hq, B);
  short_attention_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), T, S, Hq, Hkv, hd, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kF32Rows = 64;     // query rows per CTA
constexpr int kF32Keys = 64;     // keys per K/V tile
constexpr int kF32Threads = 256;
constexpr int kF32PLd = kF32Keys + 4;
constexpr float kNegInf = -1e30f;

template <int NC>  // output columns per thread: hd <= 16 NC
__global__ void __launch_bounds__(kF32Threads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int32_t* __restrict__ q_seg,
                     const int32_t* __restrict__ kv_seg, float* __restrict__ out, int T, int S,
                     int Hq, int Hkv, int hd, float scale) {
  constexpr int LD = 16 * NC + 4;
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + kF32Rows * LD;
  float* Vs = Ks + kF32Keys * LD;
  float* Ps = Vs + kF32Keys * LD;
  int* kseg = reinterpret_cast<int*>(Ps + kF32Rows * kF32PLd);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int hd4 = hd / 4;
  const bool masked = q_seg != nullptr;

  // zero the tiles once: the padding columns are read and never loaded
  for (int i = tid; i < (kF32Rows + 2 * kF32Keys) * LD; i += kF32Threads) Qs[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < kF32Rows * hd4; i += kF32Threads) {
    const int r = i / hd4, c = i - r * hd4, t = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) x = reinterpret_cast<const float4*>(q + ((size_t(b) * T + t) * Hq + h) * hd)[c];
    reinterpret_cast<float4*>(Qs + r * LD)[c] = x;
  }
  int rseg[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    rseg[i] = (masked && t < T) ? q_seg[size_t(b) * T + t] : 0;
  }

  float o[4][NC], m[4], l[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kF32Keys) {
    const int kn = min(kF32Keys, S - s0);
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kF32Keys * hd4; i += kF32Threads) {
      const int r = i / hd4, c = i - r * hd4;
      float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
      if (r < kn) {
        const size_t off = ((size_t(b) * S + s0 + r) * Hkv + hk) * hd;
        xk = reinterpret_cast<const float4*>(k + off)[c];
        xv = reinterpret_cast<const float4*>(v + off)[c];
      }
      reinterpret_cast<float4*>(Ks + r * LD)[c] = xk;
      reinterpret_cast<float4*>(Vs + r * LD)[c] = xv;
    }
    if (tid < kF32Keys) kseg[tid] = (masked && tid < kn) ? kv_seg[size_t(b) * S + s0 + tid] : 0;
    __syncthreads();

    float sc[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv4[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
      #pragma unroll
      for (int j = 0; j < 4; ++j) kv4[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv4[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv4[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv4[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv4[j].w, sc[i][j]);
        }
    }
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        float x = sc[i][j] * scale;
        if (masked && kseg[key] != rseg[i]) x = kNegInf;
        sc[i][j] = x;
        if (key < kn) mt = fmaxf(mt, x);
      }
      #pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ls = 0.f;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const float p = key < kn ? expf(sc[i][j] - mn) : 0.f;
        ls += p;
        Ps[(ty + 16 * i) * kF32PLd + key] = p;
      }
      l[i] = l[i] * alpha + ls;
      #pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; kk += 4) {
      float4 pv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kF32PLd + kk);
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NC];
        #pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = Vs[(kk + u) * LD + tx + 16 * c];
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          #pragma unroll
          for (int c = 0; c < NC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
  }

  // a row that matched no key averages v over the S keys and, as the TPU
  // kernel does, divides by the padded key count ceil(S / 128) * 128
  const float pad = float((S + 127) / 128 * 128 - S);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ls = l[i];
    #pragma unroll
    for (int off = 8; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (masked && m[i] <= kNegInf) ls += pad;
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    float* dst = out + ((size_t(b) * T + t) * Hq + h) * hd;
    #pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) dst[col] = o[i][c] / ls;
    }
  }
}

template <int NC>
int launch_f32(const float* q, const float* k, const float* v, const int32_t* q_seg,
               const int32_t* kv_seg, float* out, int B, int T, int S, int Hq, int Hkv, int hd,
               float scale, cudaStream_t stream) {
  constexpr int LD = 16 * NC + 4;
  constexpr int smem =
      ((kF32Rows + 2 * kF32Keys) * LD + kF32Rows * kF32PLd) * sizeof(float) + kF32Keys * sizeof(int);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel<NC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((T + kF32Rows - 1) / kF32Rows, Hq, B);
  attention_f32_kernel<NC><<<grid, kF32Threads, smem, stream>>>(q, k, v, q_seg, kv_seg, out, T, S,
                                                                Hq, Hkv, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 instance: q [B, T, Hq, hd], k/v [B, S, Hkv, hd], out [B, T, Hq,
// hd], all f32, contiguous and 16-byte aligned; segment ids as for bf16.
// hd % 8 == 0 and hd <= 128; Hq % Hkv == 0.  Returns a cudaError_t.
extern "C" int lavida_short_attention_f32(const void* q, const void* k, const void* v,
                                          const void* q_seg, const void* kv_seg, void* out,
                                          int B, int T, int S, int Hq, int Hkv, int hd,
                                          float scale, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* qs = static_cast<const int32_t*>(q_seg);
  const auto* ks = static_cast<const int32_t*>(kv_seg);
  auto* of = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((hd + 15) / 16) {
    case 1: return launch_f32<1>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    case 2: return launch_f32<2>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    case 3: return launch_f32<3>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    case 4: return launch_f32<4>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    case 5: return launch_f32<5>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    case 6: return launch_f32<6>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    case 7: return launch_f32<7>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    case 8: return launch_f32<8>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, hd, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q [B, T, Hq, hd], k/v [B, S, Hkv, hd], out [B, T, Hq, hd], all bf16,
// contiguous and 16-byte aligned; q_seg [B, T] / kv_seg [B, S] int32, or
// both null for no mask.  hd % 8 == 0 and hd <= 128; Hq % Hkv == 0.
// Returns a cudaError_t.
extern "C" int lavida_short_attention_bf16(const void* q, const void* k, const void* v,
                                           const void* q_seg, const void* kv_seg,
                                           void* out, int B, int T, int S, int Hq,
                                           int Hkv, int hd, float scale, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qs = static_cast<const int32_t*>(q_seg);
  const auto* ks = static_cast<const int32_t*>(kv_seg);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((hd + 15) / 16 * 16) {
    case 16: return launch<16>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    case 32: return launch<32>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    case 48: return launch<48>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    case 64: return launch<64>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    case 80: return launch<80>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    case 96: return launch<96>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    case 112: return launch<112>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    case 128: return launch<128>(q, k, v, qs, ks, out, B, T, S, Hq, Hkv, hd, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
