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
// and p stays f32.  Its products are 4 B H T S hd operations, which on the
// CUDA cores' 67 TFLOP/s of FFMA are the bound, while the tensor cores have
// no f32 product: TF32 keeps 10 mantissa bits, about 3 digits.  So the
// instance takes both products in 3xTF32 (`attention_f32_tc_kernel`): each
// operand splits as x = big + small, both rounded to TF32, and a b = a_s b_b
// + a_b b_s + a_b b_b (the small terms first) on `mma.sync.m16n8k8` TF32
// with f32 accumulators, which keeps f32's accuracy at three times the
// tensor-core work: 3 x 4 B H T S hd at 495 TFLOP/s is the bound then.
// The FlashAttention-2 shape on `mma.sync`: a CTA of 4 warps takes 128
// query rows of one head (two m16 tiles a warp; above hd 80 one, so 64
// rows), keeps them f32 in shared memory, and walks 32-key K/V tiles on a
// two-stage cp.async ring (the next tile copies while this one multiplies;
// keys past S zero-filled), with an online softmax in the log2 domain
// (log2 e folded into the scale, ex2) whose p stays in the registers of
// the score fragments: the fragment of keys 2 t, 2 t + 1 is the A fragment
// of columns t, t + 4, so V is read in key pairs.  Each split costs 5
// integer and float operations (the rounding is integer arithmetic: the
// cvt instruction compiles to a longer compare-and-select sequence), and
// with every warp splitting the K/V fragments it reads, the splits took
// longer than the products.  So the CTA splits each K/V tile once into
// packed tiles, a uint4 {big, big, small, small} per fragment pair, one
// shared load each; Q is split as its fragments are read (packed, it
// would double its shared memory and halve the CTAs an SM), p in
// registers.  What bounds it then is the mma.sync TF32 rate itself.
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

// ---- the f32 instance: 3xTF32 on the tensor cores ----

constexpr int kTcWarps = 4;
constexpr int kTcKeys = 32;                 // keys per K/V tile
constexpr int kTcGroups = kTcKeys / 8;      // its n8 / k8 key groups
constexpr int kTcStages = 2;                // the cp.async ring
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxKs2 = 10;               // up to hd 80 a warp takes two m16 tiles
constexpr float kNegInf = -1e30f;

// One CTA's shared memory for hd = 8 KS, in words.  A warp owns kMt tiles
// of 16 query rows, so every K/V fragment it reads feeds kMt products (one
// for hd above 80, where two would not fit the registers).  Q stays f32
// and is split as its fragments are read, as float2 pairs at (row g,
// column 2 t): a row stride of 8 or 24 mod 32 keeps a half warp's 4 x 4
// (g, t) in distinct banks.  Each K/V tile lands raw in a ring stage and
// is split once into packed tiles, a uint4 {big 2 t, big 2 t + 1, small 2
// t, small 2 t + 1} per fragment pair: K's rows hold head-dim pairs (a
// stride of 16 mod 32 words keeps a quarter warp's 2 x 4 (g, t) reads in
// distinct banks), V's hold key pairs (2 t, 2 t + 1) by column (a stride
// of 8 or 24 mod 32 words).
template <int KS>
struct TcLayout {
  static constexpr int kHd = 8 * KS;
  static constexpr int kMt = KS <= kTcMaxKs2 ? 2 : 1;
  static constexpr int kRows = 16 * kMt * kTcWarps;           // query rows per CTA
  static constexpr int kLdK = kHd % 16 ? kHd : kHd + 8;
  static constexpr int kQ = kRows * kLdK;
  static constexpr int kK = kTcKeys * kHd;                    // raw K / V tiles
  static constexpr int kV = kTcKeys * kHd;
  static constexpr int kStage = kK + kV + kTcKeys;            // + the keys' segment ids
  static constexpr int kLdKp = kHd % 16 ? 2 * kHd : 2 * kHd + 16;  // packed K row
  static constexpr int kLdVp = 4 * (kHd + 2);                 // packed V key pair
  static constexpr int kKp = kTcKeys * kLdKp;
  static constexpr int kVp = kTcKeys / 2 * kLdVp;
  static constexpr int kBytes = (kQ + kTcStages * kStage + kKp + kVp) * 4;
};

// x = big + small + O(2^-22 |x|): big is x rounded to TF32 to nearest,
// ties away from zero (cvt.rna.tf32.f32's rounding, as integer arithmetic:
// the cvt instruction compiles to a longer compare-and-select sequence),
// small the rest, rounded the same way.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(__float_as_uint(x));
  small = rna_tf32(__float_as_uint(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small cross terms first, then big x big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int32_t* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy K/V tile `tile` (keys past S zero-filled) and its keys' segment ids
// into a ring stage; one cp.async group per call.
template <int KS>
__device__ __forceinline__ void load_kv_tile(float* stage, const float* k, const float* v,
                                             const int32_t* kv_seg, int b, int hk, int S,
                                             int Hkv, int tile) {
  using L = TcLayout<KS>;
  constexpr int kChunks = 2 * KS;  // 16-byte chunks of a row
  const int s0 = tile * kTcKeys;
  for (int i = threadIdx.x; i < kTcKeys * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool valid = s0 + r < S;
    const size_t off = valid ? ((size_t(b) * S + s0 + r) * Hkv + hk) * L::kHd + 4 * c : 0;
    cp_async16(stage + r * L::kHd + 4 * c, k + off, valid);
    cp_async16(stage + L::kK + r * L::kHd + 4 * c, v + off, valid);
  }
  if (kv_seg != nullptr && threadIdx.x < kTcKeys) {
    const int r = threadIdx.x;
    const bool valid = s0 + r < S;
    cp_async4(reinterpret_cast<int*>(stage + L::kK + L::kV) + r,
              kv_seg + (valid ? size_t(b) * S + s0 + r : 0), valid);
  }
  cp_async_commit();
}

template <int KS>  // hd = 8 KS
__global__ void __launch_bounds__(kTcThreads, 2)
attention_f32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int32_t* __restrict__ q_seg,
                        const int32_t* __restrict__ kv_seg, float* __restrict__ out, int T,
                        int S, int Hq, int Hkv, float scale_log2) {
  using L = TcLayout<KS>;
  constexpr int hd = L::kHd, MT = L::kMt;
  extern __shared__ __align__(16) float smem_tc[];
  float* const q_raw = smem_tc;
  float* const ring = q_raw + L::kQ;
  uint4* const kp = reinterpret_cast<uint4*>(ring + kTcStages * L::kStage);
  uint4* const vp = kp + L::kKp / 4;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int q0 = blockIdx.x * L::kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bool masked = q_seg != nullptr;
  const int n_tiles = (S + kTcKeys - 1) / kTcKeys;

#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < n_tiles) {
      load_kv_tile<KS>(ring + i * L::kStage, k, v, kv_seg, b, hk, S, Hkv, i);
    } else {
      cp_async_commit();
    }
  }
  // Q in f32, split as its fragments are read (rows past T are zero)
  for (int i = threadIdx.x; i < L::kRows * 2 * KS; i += kTcThreads) {
    const int r = i / (2 * KS), c = i - r * (2 * KS), row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < T) x = reinterpret_cast<const float4*>(q + ((size_t(b) * T + row) * Hq + h) * hd)[c];
    reinterpret_cast<float4*>(q_raw + r * L::kLdK)[c] = x;
  }
  // m16 tile i of this warp: rows r0[i] (fragment elements 0, 1) and
  // r0[i] + 8 (elements 2, 3)
  int r0[MT], qs[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    r0[i] = 16 * (MT * warp + i) + g;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + r0[i] + 8 * e;
      qs[i][e] = (masked && row < T) ? q_seg[size_t(b) * T + row] : 0;
    }
  }

  float o[MT][KS][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < KS; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kTcStages - 2>();  // this thread's copies of `tile` landed
    __syncthreads();                 // everyone's; the stage of tile - 1 is free
    {
      const int next = tile + kTcStages - 1;
      if (next < n_tiles) {
        load_kv_tile<KS>(ring + (next % kTcStages) * L::kStage, k, v, kv_seg, b, hk, S, Hkv, next);
      } else {
        cp_async_commit();
      }
    }
    const float* ks = ring + (tile % kTcStages) * L::kStage;
    const float* vs = ks + L::kK;
    const int* kseg = reinterpret_cast<const int*>(vs + L::kV);
    const int kn = min(kTcKeys, S - tile * kTcKeys);  // keys of this tile
    // split the tile once for all warps, packed as {big 2 t, big 2 t + 1,
    // small 2 t, small 2 t + 1} per fragment pair: K's head-dim pairs, V's
    // key pairs
    for (int i = threadIdx.x; i < kTcKeys * 2 * KS; i += kTcThreads) {
      const int r = i / (2 * KS), c = i - r * (2 * KS);
      const float4 x = reinterpret_cast<const float4*>(ks + r * L::kHd)[c];
      uint4 p0, p1;
      split_tf32(x.x, p0.x, p0.z);
      split_tf32(x.y, p0.y, p0.w);
      split_tf32(x.z, p1.x, p1.z);
      split_tf32(x.w, p1.y, p1.w);
      uint4* dst = kp + r * (L::kLdKp / 4) + 2 * c;
      dst[0] = p0;
      dst[1] = p1;
    }
    for (int i = threadIdx.x; i < kTcKeys / 2 * 2 * KS; i += kTcThreads) {
      const int p = i / (2 * KS), c = i - p * (2 * KS);
      const float4 x0 = reinterpret_cast<const float4*>(vs + 2 * p * L::kHd)[c];
      const float4 x1 = reinterpret_cast<const float4*>(vs + (2 * p + 1) * L::kHd)[c];
      uint4 d0, d1, d2, d3;
      split_tf32(x0.x, d0.x, d0.z);
      split_tf32(x1.x, d0.y, d0.w);
      split_tf32(x0.y, d1.x, d1.z);
      split_tf32(x1.y, d1.y, d1.w);
      split_tf32(x0.z, d2.x, d2.z);
      split_tf32(x1.z, d2.y, d2.w);
      split_tf32(x0.w, d3.x, d3.z);
      split_tf32(x1.w, d3.y, d3.w);
      uint4* dst = vp + p * (L::kLdVp / 4) + 4 * c;
      dst[0] = d0;
      dst[1] = d1;
      dst[2] = d2;
      dst[3] = d3;
    }
    __syncthreads();

    // S = Q K^T.  Inside each k-step of 8 the head dim is read permuted
    // (fragment column t <- 2 t, t + 4 <- 2 t + 1) for Q and K alike, so
    // each operand pair is one float2 (Q) or one packed uint4 (K).
    float s[MT][kTcGroups][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kTcGroups; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int col = 8 * kk + 2 * t;
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float2 x0 = *reinterpret_cast<const float2*>(q_raw + r0[i] * L::kLdK + col);
        const float2 x1 = *reinterpret_cast<const float2*>(q_raw + (r0[i] + 8) * L::kLdK + col);
        split_tf32(x0.x, ab[i][0], as[i][0]);
        split_tf32(x1.x, ab[i][1], as[i][1]);
        split_tf32(x0.y, ab[i][2], as[i][2]);
        split_tf32(x1.y, ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kTcGroups; ++j) {
        if (8 * j < kn) {  // uniform: key groups past S are skipped
          const uint4 kf = kp[(8 * j + g) * (L::kLdKp / 4) + 4 * kk + t];
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_3xtf32(s[i][j], ab[i], as[i], kf.x, kf.y, kf.z, kf.w);
        }
      }
    }

    // online softmax in the log2 domain: s[i][j] holds keys 8 j + 2 t +
    // {0, 1} of tile i's two rows
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTcGroups; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * t + e;
          float a = s[i][j][e] * scale_log2, c = s[i][j][2 + e] * scale_log2;
          if (key >= kn) {
            a = c = -INFINITY;  // past S: out of the softmax
          } else if (masked) {
            const int ksg = kseg[key];
            if (ksg != qs[i][0]) a = kNegInf;
            if (ksg != qs[i][1]) c = kNegInf;
          }
          s[i][j][e] = a;
          s[i][j][2 + e] = c;
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, c);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // key 0 of every tile is below S, so the new maxima are finite
      const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
      const float alpha0 = ex2(m[i][0] - mn0), alpha1 = ex2(m[i][1] - mn1);
      m[i][0] = mn0;
      m[i][1] = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kTcGroups; ++j) {
        s[i][j][0] = ex2(s[i][j][0] - mn0);
        s[i][j][1] = ex2(s[i][j][1] - mn0);
        s[i][j][2] = ex2(s[i][j][2] - mn1);
        s[i][j][3] = ex2(s[i][j][3] - mn1);
        sum0 += s[i][j][0] + s[i][j][1];
        sum1 += s[i][j][2] + s[i][j][3];
      }
      l[i][0] = l[i][0] * alpha0 + sum0;
      l[i][1] = l[i][1] * alpha1 + sum1;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[i][n][0] *= alpha0;
        o[i][n][1] *= alpha0;
        o[i][n][2] *= alpha1;
        o[i][n][3] *= alpha1;
      }
    }

    // O += P V with p kept in f32 and split in registers.  The score
    // fragment of key group j holds keys 2 t, 2 t + 1, which the A fragment
    // takes as columns t, t + 4: V's packed key pair (2 t, 2 t + 1) is its
    // B fragment.
#pragma unroll
    for (int j = 0; j < kTcGroups; ++j) {
      if (8 * j < kn) {
        uint32_t pb[MT][4], ps[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          split_tf32(s[i][j][0], pb[i][0], ps[i][0]);
          split_tf32(s[i][j][2], pb[i][1], ps[i][1]);
          split_tf32(s[i][j][1], pb[i][2], ps[i][2]);
          split_tf32(s[i][j][3], pb[i][3], ps[i][3]);
        }
        const uint4* v0 = vp + (4 * j + t) * (L::kLdVp / 4) + g;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          const uint4 vf = v0[8 * n];
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_3xtf32(o[i][n], pb[i], ps[i], vf.x, vf.y, vf.z, vf.w);
        }
      }
    }
  }
  cp_async_wait<0>();

  // a row that matched no key averages v over the S keys and, as the TPU
  // kernel does, divides by the padded key count ceil(S / 128) * 128
  const float pad = float((S + 127) / 128 * 128 - S);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float ls = l[i][e];
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      if (masked && m[i][e] <= kNegInf) ls += pad;
      const int row = q0 + r0[i] + 8 * e;
      if (row < T) {
        float* dst = out + ((size_t(b) * T + row) * Hq + h) * hd + 2 * t;
#pragma unroll
        for (int n = 0; n < KS; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[i][n][2 * e] / ls, o[i][n][2 * e + 1] / ls);
      }
    }
  }
}

template <int KS>
int launch_f32(const float* q, const float* k, const float* v, const int32_t* q_seg,
               const int32_t* kv_seg, float* out, int B, int T, int S, int Hq, int Hkv,
               float scale, cudaStream_t stream) {
  using L = TcLayout<KS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_f32_tc_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((T + L::kRows - 1) / L::kRows, Hq, B);
  attention_f32_tc_kernel<KS><<<grid, kTcThreads, L::kBytes, stream>>>(
      q, k, v, q_seg, kv_seg, out, T, S, Hq, Hkv, scale * kLog2e);
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
  switch (hd / 8) {
    case 1: return launch_f32<1>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 2: return launch_f32<2>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 3: return launch_f32<3>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 4: return launch_f32<4>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 5: return launch_f32<5>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 6: return launch_f32<6>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 7: return launch_f32<7>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 8: return launch_f32<8>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 9: return launch_f32<9>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 10: return launch_f32<10>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 11: return launch_f32<11>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 12: return launch_f32<12>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 13: return launch_f32<13>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 14: return launch_f32<14>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 15: return launch_f32<15>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
    case 16: return launch_f32<16>(qf, kf, vf, qs, ks, of, B, T, S, Hq, Hkv, scale, st);
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
