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
// What bounds it on the H100: at the slice's shapes (SigLIP 5 x 16 heads
// x 729 x 729, hd 72; LLaDA prefill 32 heads x 1056 x 1088, hd 128) the
// work is tensor-core math on tiles that are read once per query tile, so
// it is compute-bound once enough CTAs are in flight.  The TPU kernel keeps
// a whole [S, hd] K/V head in VMEM and takes one single-pass softmax; a
// 1088 x 128 bf16 K plus V head is 557 KB, which does not fit the 227 KB of
// shared memory a CTA can have.
//
// What the design does about it: one CTA of 4 warps per (query tile of 64
// rows, q-head, batch).  K/V stream through shared memory in tiles of 64
// rows with an online softmax in f32 registers (running max m and sum l),
// so any S works without a cap.  Both products run on bf16 tensor cores
// through mma.sync.m16n8k16 with f32 accumulators; each warp owns 16 query
// rows.  p is rounded to bf16 per tile before its PV product, as the TPU
// kernel rounds its single-pass p.  The head dim is zero-padded to a
// multiple of 16 in shared memory (SigLIP so400m has hd = 72), and the
// ragged T/S edges are masked in the kernel: keys past S get -inf (they
// leave the softmax), query rows past T are not stored.  Later work:
// cp.async/TMA double buffering and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per CTA (16 per warp)
constexpr int kBlockN = 64;   // key rows per streamed tile
constexpr int kThreads = 128;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16, row-major) * B(16x8, column-major); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices from shared memory, transposed on the way in: the
// B operand of the PV product from a row-major [key][dim] V tile.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// Copy `rows` rows of `hd` bf16 (row stride `stride` elements) into a
// [64][LD] shared tile with 16-byte loads; rows >= `rows` and columns >= hd
// are zero-filled.
template <int HDP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long stride, int rows, int hd) {
  constexpr int LD = HDP + 8;
  constexpr int CHUNKS = HDP / 8;
  for (int i = threadIdx.x; i < kBlockN * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < hd) {
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
short_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int32_t* __restrict__ q_seg,
                       const int32_t* __restrict__ kv_seg,
                       __nv_bfloat16* __restrict__ out, int T, int S, int Hq,
                       int Hkv, int hd, float scale) {
  constexpr int LD = HDP + 8;        // +8 bf16 per row: conflict-free reads
  constexpr int KSTEPS = HDP / 16;   // k-steps of the QK^T product
  constexpr int DBLKS = HDP / 8;     // 8-wide output column blocks
  constexpr int NBLKS = kBlockN / 8; // 8-wide score column blocks

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * LD;
  __nv_bfloat16* sV = sK + kBlockN * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t4 = lane & 3;  // fragment column pair
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int hk = h / (Hq / Hkv);

  const long q_stride = static_cast<long>(Hq) * hd;
  const long kv_stride = static_cast<long>(Hkv) * hd;
  const __nv_bfloat16* qb = q + static_cast<long>(b) * T * q_stride + static_cast<long>(h) * hd;
  const __nv_bfloat16* kb = k + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * hd;
  const __nv_bfloat16* vb = v + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * hd;

  load_tile<HDP>(sQ, qb + q0 * q_stride, q_stride, min(kBlockM, T - q0), hd);
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept in registers.
  const int r0 = warp * 16 + g;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = lds32(sQ + r0 * LD + c);
    qf[kk][1] = lds32(sQ + (r0 + 8) * LD + c);
    qf[kk][2] = lds32(sQ + r0 * LD + c + 8);
    qf[kk][3] = lds32(sQ + (r0 + 8) * LD + c + 8);
  }

  const bool masked = q_seg != nullptr;
  int qs0 = 0, qs1 = 0;
  if (masked) {
    const int ta = q0 + r0, tb = q0 + r0 + 8;
    qs0 = ta < T ? q_seg[static_cast<long>(b) * T + ta] : 0;
    qs1 = tb < T ? q_seg[static_cast<long>(b) * T + tb] : 0;
  }
  const int32_t* kvs = masked ? kv_seg + static_cast<long>(b) * S : nullptr;

  // Running max / sum for rows r0 and r0 + 8 (the sum is this thread's
  // partial over its columns; the quad is reduced once at the end).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[DBLKS][4];
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    const int rows = min(kBlockN, S - kv0);
    load_tile<HDP>(sK, kb + kv0 * kv_stride, kv_stride, rows, hd);
    load_tile<HDP>(sV, vb + kv0 * kv_stride, kv_stride, rows, hd);
    __syncthreads();

    float s[NBLKS][4];
#pragma unroll
    for (int j = 0; j < NBLKS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = sK + (j * 8 + g) * LD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16816(s[j], qf[kk], lds32(krow + kk * 16), lds32(krow + kk * 16 + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NBLKS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = kv0 + j * 8 + 2 * t4 + e;
        float a = s[j][e] * scale;
        float bb = s[j][2 + e] * scale;
        if (c >= S) {
          a = -INFINITY;
          bb = -INFINITY;
        } else if (masked) {
          const int ks = kvs[c];
          if (ks != qs0) a = kMaskValue;
          if (ks != qs1) bb = kMaskValue;
        }
        s[j][e] = a;
        s[j][2 + e] = bb;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, bb);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // Column kv0 < S is in range, so the new max is finite.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int d = 0; d < DBLKS; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }

    // p = exp(s - m) in f32 (summed unrounded, as the TPU kernel sums its
    // f32 p), then rounded to bf16 as the A operand of the PV product.
    uint32_t pf[kBlockN / 16][4];
#pragma unroll
    for (int j = 0; j < NBLKS; ++j) {
      const float p00 = expf(s[j][0] - m0), p01 = expf(s[j][1] - m0);
      const float p10 = expf(s[j][2] - m1), p11 = expf(s[j][3] - m1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      const int half = (j & 1) * 2;
      pf[j >> 1][half + 0] = pack_bf16x2(p00, p01);
      pf[j >> 1][half + 1] = pack_bf16x2(p10, p11);
    }

#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const __nv_bfloat16* vrow = sV + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int d = 0; d < DBLKS; ++d) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, vrow + d * 8);
        mma_16816(acc[d], pf[kk], b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const int ta = q0 + r0, tb = q0 + r0 + 8;
  __nv_bfloat16* oa = out + (static_cast<long>(b) * T + ta) * q_stride + static_cast<long>(h) * hd;
  __nv_bfloat16* ob = out + (static_cast<long>(b) * T + tb) * q_stride + static_cast<long>(h) * hd;
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) {
    const int c = d * 8 + 2 * t4;
    if (c < hd) {  // hd % 8 == 0: the pair c, c + 1 is in range together
      if (ta < T) {
        *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16x2(acc[d][0] / l0, acc[d][1] / l0);
      }
      if (tb < T) {
        *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16x2(acc[d][2] / l1, acc[d][3] / l1);
      }
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const int32_t* q_seg,
           const int32_t* kv_seg, void* out, int B, int T, int S, int Hq,
           int Hkv, int hd, float scale, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (HDP + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(short_attention_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBlockM - 1) / kBlockM, Hq, B);
  short_attention_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), T, S, Hq, Hkv, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, T, Hq, hd], k/v [B, S, Hkv, hd], out [B, T, Hq, hd], all bf16 and
// contiguous; q_seg [B, T] / kv_seg [B, S] int32, or both null for no mask.
// hd % 8 == 0 and hd <= 128; Hq % Hkv == 0.  Returns a cudaError_t.
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
