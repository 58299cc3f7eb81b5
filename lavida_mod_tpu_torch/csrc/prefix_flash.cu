// Prefix-LM flash attention for training on Hopper (sm_90a): the forward,
// and the two backward kernels dq and dk/dv.
//
// Replaces: lavida_mod_tpu/ops/prefix_flash.py, the three Pallas TPU kernels
// behind `prefix_flash_attention` (`_fwd_kernel`, `_dq_kernel`,
// `_dkv_kernel`), which the LLaDA blocks run in every training step
// (attention_impl="prefix_flash").
//
// What it computes (as the TPU kernels), over sequence indices q < T, kv < S:
//   visible(b, q, kv) = kv_valid[b, kv] && (kv < plen[b] || q >= plen[b])
//   forward: s = q . k^T * scale, masked with the finite -1e30; an online
//     softmax over K/V tiles with m starting at -1e30 and the rescale guarded
//     as alpha = exp(min(m_prev - m_new, 0)); p = exp(s - m) summed in f32 and
//     rounded to v's type before the PV product; o = acc / max(l, 1e-30) and
//     lse = m + log(max(l, 1e-30)) [B, Hq, T] f32.
//   dq:  p = visible ? exp(s - lse) : 0, dp = dO . V^T, ds = p * (dp - delta),
//        dq = scale * bf16(ds) @ K, with delta = sum(dO * o) over hd computed
//        outside (ops/prefix_flash.py);
//   dkv: dv = bf16(p)^T @ dO and dk = scale * bf16(ds)^T @ Q, summed over the
//        GQA group's q heads and all query tiles.
// A row whose first K/V tile holds no visible key sums exp(0) = 1 for that
// tile's masked keys until a visible key's max clears them through alpha =
// 0, as the TPU kernel does.  Keys past S (the ragged edge) get -inf and
// never enter a sum: the TPU wrapper pads S to its 512 block with masked
// keys instead, which only differs for a row with no visible key at all.
//
// What bounds it on the H100: at the stage-1 training shape (8 rows of 1152
// tokens, 32 heads, hd 128) every kernel is tensor-core math on tiles read
// once per CTA (4 / 6 / 8 x B*Hq*T*S*hd operations for fwd / dq / dkv), so
// it is compute-bound when enough CTAs are in flight (4608 per launch).
//
// What the design does about it (a simple first version): the TPU kernels
// hold 512 x 512 blocks in VMEM and carry their sums across a sequential
// grid axis; here a loop inside one CTA takes that axis's place.  fwd and dq:
// one CTA of 4 warps per (64-row query tile, q head, batch row), each warp
// owning 16 query rows, K/V streamed through shared memory in 64-row tiles.
// dkv: one CTA per (64-key tile, kv head, batch row), each warp owning 16
// keys, looping over the group's q heads and all 32-row query tiles, so dk
// and dv accumulate in registers with no atomics.  Every product is
// mma.sync.m16n8k16 bf16 with f32 accumulators; operands that are consumed
// transposed come through ldmatrix.trans.  The head dim is zero-padded in
// shared memory, ragged edges are masked in the kernel, and q/k/v are read
// in their [B, T, H, hd] layout (no transposes, no padding to a block).
// Later work: cp.async/TMA pipelining and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;    // fwd / dq: query rows per CTA (16 per warp)
constexpr int kBlockKV = 64;   // fwd / dq: keys per streamed tile; dkv: keys per CTA
constexpr int kBlockQT = 32;   // dkv: query rows per streamed tile
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

// Two 8x8 bf16 matrices from shared memory, transposed on the way in: the B
// operand (k = row of the tile) of a product with a row-major [row][dim] tile.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The A fragment (16 rows x 16 columns at column kk * 16) of a row-major
// [rows][LD] shared tile, rows r0 and r0 + 8 for this lane.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int r0, int kk, int t4) {
  const __nv_bfloat16* p = tile + r0 * LD + kk * 16 + 2 * t4;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LD);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LD + 8);
}

// Copy `rows` rows of `hd` bf16 (row stride `stride` elements) into a
// [ROWS][HDP + 8] shared tile with 16-byte loads; rows >= `rows` and columns
// >= hd are zero-filled.
template <int HDP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long stride, int rows, int hd) {
  constexpr int LD = HDP + 8;
  constexpr int CHUNKS = HDP / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < hd) {
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int plen, int kvalid) {
  return kvalid != 0 && (kpos < plen || qpos >= plen);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Args {
  const __nv_bfloat16* q;   // [B, T, Hq, hd]
  const __nv_bfloat16* k;   // [B, S, Hkv, hd]
  const __nv_bfloat16* v;   // [B, S, Hkv, hd]
  const int32_t* plen;      // [B]
  const int32_t* kv_valid;  // [B, S]
  const __nv_bfloat16* dout;  // [B, T, Hq, hd] (backward)
  float* lse;               // [B, Hq, T] (written by fwd, read by the backward)
  const float* delta;       // [B, Hq, T] (backward)
  __nv_bfloat16* o;         // fwd: out [B, T, Hq, hd]; dq: dq
  __nv_bfloat16* dk;        // dkv: [B, S, Hkv, hd]
  __nv_bfloat16* dv;        // dkv: [B, S, Hkv, hd]
  int T, S, Hq, Hkv, hd;
  float scale;
};

// ---------------------------------------------------------------------------
// forward: grid (ceil(T / 64), Hq, B)
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(kThreads) prefix_flash_fwd_kernel(Args a) {
  constexpr int LD = HDP + 8;
  constexpr int KSTEPS = HDP / 16;
  constexpr int DBLKS = HDP / 8;
  constexpr int NBLKS = kBlockKV / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockQ * LD;
  __nv_bfloat16* sV = sK + kBlockKV * LD;
  int* sValid = reinterpret_cast<int*>(sV + kBlockKV * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int T = a.T, S = a.S, hd = a.hd;
  const int hk = h / (a.Hq / a.Hkv);
  const int pl = a.plen[b];
  const long q_stride = static_cast<long>(a.Hq) * hd;
  const long kv_stride = static_cast<long>(a.Hkv) * hd;
  const __nv_bfloat16* qb = a.q + static_cast<long>(b) * T * q_stride + static_cast<long>(h) * hd;
  const __nv_bfloat16* kb = a.k + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * hd;
  const __nv_bfloat16* vb = a.v + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * hd;
  const int32_t* valid = a.kv_valid + static_cast<long>(b) * S;

  load_tile<HDP, kBlockQ>(sQ, qb + q0 * q_stride, q_stride, min(kBlockQ, T - q0), hd);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) load_a<LD>(qf[kk], sQ, r0, kk, t4);
  const int ta = q0 + r0, tb = ta + 8;

  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;
  float acc[DBLKS][4];
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed
    const int rows = min(kBlockKV, S - kv0);
    load_tile<HDP, kBlockKV>(sK, kb + kv0 * kv_stride, kv_stride, rows, hd);
    load_tile<HDP, kBlockKV>(sV, vb + kv0 * kv_stride, kv_stride, rows, hd);
    if (threadIdx.x < kBlockKV) sValid[threadIdx.x] = threadIdx.x < rows ? valid[kv0 + threadIdx.x] : 0;
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
        const int cl = j * 8 + 2 * t4 + e;
        const int c = kv0 + cl;
        float x0 = s[j][e] * a.scale, x1 = s[j][2 + e] * a.scale;
        if (c >= S) {
          x0 = x1 = -INFINITY;
        } else {
          if (!visible(ta, c, pl, sValid[cl])) x0 = kMaskValue;
          if (!visible(tb, c, pl, sValid[cl])) x1 = kMaskValue;
        }
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    // column kv0 < S is in the tile, so the tile max is at least -1e30
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = expf(fminf(m0 - mn0, 0.f)), alpha1 = expf(fminf(m1 - mn1, 0.f));
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

    // p = exp(s - m) in f32 (summed unrounded), rounded to bf16 for PV
    uint32_t pf[kBlockKV / 16][4];
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
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      const __nv_bfloat16* vrow = sV + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int d = 0; d < DBLKS; ++d) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, vrow + d * 8);
        mma_16816(acc[d], pf[kk], b0, b1);
      }
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* oa = a.o + (static_cast<long>(b) * T + ta) * q_stride + static_cast<long>(h) * hd;
  __nv_bfloat16* ob = a.o + (static_cast<long>(b) * T + tb) * q_stride + static_cast<long>(h) * hd;
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) {
    const int c = d * 8 + 2 * t4;
    if (c < hd) {  // hd % 8 == 0: the pair c, c + 1 is in range together
      if (ta < T) *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16x2(acc[d][0] / l0, acc[d][1] / l0);
      if (tb < T) *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16x2(acc[d][2] / l1, acc[d][3] / l1);
    }
  }
  if (t4 == 0) {
    float* lse = a.lse + (static_cast<long>(b) * a.Hq + h) * T;
    if (ta < T) lse[ta] = m0 + logf(l0);
    if (tb < T) lse[tb] = m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(T / 64), Hq, B)
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(kThreads) prefix_flash_dq_kernel(Args a) {
  constexpr int LD = HDP + 8;
  constexpr int KSTEPS = HDP / 16;
  constexpr int DBLKS = HDP / 8;
  constexpr int NBLKS = kBlockKV / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kBlockQ * LD;
  __nv_bfloat16* sK = sdO + kBlockQ * LD;
  __nv_bfloat16* sV = sK + kBlockKV * LD;
  int* sValid = reinterpret_cast<int*>(sV + kBlockKV * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int T = a.T, S = a.S, hd = a.hd;
  const int hk = h / (a.Hq / a.Hkv);
  const int pl = a.plen[b];
  const long q_stride = static_cast<long>(a.Hq) * hd;
  const long kv_stride = static_cast<long>(a.Hkv) * hd;
  const long q_off = static_cast<long>(b) * T * q_stride + static_cast<long>(h) * hd;
  const __nv_bfloat16* kb = a.k + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * hd;
  const __nv_bfloat16* vb = a.v + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * hd;
  const int32_t* valid = a.kv_valid + static_cast<long>(b) * S;

  const int qrows = min(kBlockQ, T - q0);
  load_tile<HDP, kBlockQ>(sQ, a.q + q_off + q0 * q_stride, q_stride, qrows, hd);
  load_tile<HDP, kBlockQ>(sdO, a.dout + q_off + q0 * q_stride, q_stride, qrows, hd);
  const int r0 = warp * 16 + g;
  const int ta = q0 + r0, tb = ta + 8;
  const long row_off = (static_cast<long>(b) * a.Hq + h) * T;
  const float lse0 = ta < T ? a.lse[row_off + ta] : 0.f;
  const float lse1 = tb < T ? a.lse[row_off + tb] : 0.f;
  const float del0 = ta < T ? a.delta[row_off + ta] : 0.f;
  const float del1 = tb < T ? a.delta[row_off + tb] : 0.f;

  float acc[DBLKS][4];
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += kBlockKV) {
    __syncthreads();
    const int rows = min(kBlockKV, S - kv0);
    load_tile<HDP, kBlockKV>(sK, kb + kv0 * kv_stride, kv_stride, rows, hd);
    load_tile<HDP, kBlockKV>(sV, vb + kv0 * kv_stride, kv_stride, rows, hd);
    if (threadIdx.x < kBlockKV) sValid[threadIdx.x] = threadIdx.x < rows ? valid[kv0 + threadIdx.x] : 0;
    __syncthreads();

    // s = Q K^T and dp = dO V^T for this warp's 16 rows
    float s[NBLKS][4], dp[NBLKS][4];
#pragma unroll
    for (int j = 0; j < NBLKS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, sQ, r0, kk, t4);
      load_a<LD>(ado, sdO, r0, kk, t4);
#pragma unroll
      for (int j = 0; j < NBLKS; ++j) {
        const int off = (j * 8 + g) * LD + 2 * t4 + kk * 16;
        mma_16816(s[j], aq, lds32(sK + off), lds32(sK + off + 8));
        mma_16816(dp[j], ado, lds32(sV + off), lds32(sV + off + 8));
      }
    }

    // ds = p * (dp - delta), p = visible ? exp(s - lse) : 0; packed as the
    // bf16 A operand of ds @ K
    uint32_t dsf[kBlockKV / 16][4];
#pragma unroll
    for (int j = 0; j < NBLKS; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = j * 8 + 2 * t4 + e;
        const int c = kv0 + cl;
        const bool in = c < S;
        const float p0 = in && ta < T && visible(ta, c, pl, sValid[cl])
                             ? expf(s[j][e] * a.scale - lse0) : 0.f;
        const float p1 = in && tb < T && visible(tb, c, pl, sValid[cl])
                             ? expf(s[j][2 + e] * a.scale - lse1) : 0.f;
        ds[e] = p0 * (dp[j][e] - del0);
        ds[2 + e] = p1 * (dp[j][2 + e] - del1);
      }
      const int half = (j & 1) * 2;
      dsf[j >> 1][half + 0] = pack_bf16x2(ds[0], ds[1]);
      dsf[j >> 1][half + 1] = pack_bf16x2(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      const __nv_bfloat16* krow = sK + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int d = 0; d < DBLKS; ++d) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, krow + d * 8);
        mma_16816(acc[d], dsf[kk], b0, b1);
      }
    }
  }

  __nv_bfloat16* oa = a.o + q_off + static_cast<long>(ta) * q_stride;
  __nv_bfloat16* ob = a.o + q_off + static_cast<long>(tb) * q_stride;
  const float sc = a.scale;
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) {
    const int c = d * 8 + 2 * t4;
    if (c < hd) {
      if (ta < T) *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16x2(sc * acc[d][0], sc * acc[d][1]);
      if (tb < T) *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16x2(sc * acc[d][2], sc * acc[d][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv: grid (ceil(S / 64), Hkv, B); loops over the group's q heads and
// every 32-row query tile.  The products run transposed: rows are keys.
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(kThreads) prefix_flash_dkv_kernel(Args a) {
  constexpr int LD = HDP + 8;
  constexpr int KSTEPS = HDP / 16;
  constexpr int DBLKS = HDP / 8;
  constexpr int NBLKS = kBlockQT / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBlockKV * LD;
  __nv_bfloat16* sQ = sV + kBlockKV * LD;
  __nv_bfloat16* sdO = sQ + kBlockQT * LD;
  float* sLse = reinterpret_cast<float*>(sdO + kBlockQT * LD);
  float* sDelta = sLse + kBlockQT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, kv0 = blockIdx.x * kBlockKV;
  const int T = a.T, S = a.S, hd = a.hd;
  const int G = a.Hq / a.Hkv;
  const int pl = a.plen[b];
  const long q_stride = static_cast<long>(a.Hq) * hd;
  const long kv_stride = static_cast<long>(a.Hkv) * hd;
  const long kv_off = static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * hd;

  load_tile<HDP, kBlockKV>(sK, a.k + kv_off + kv0 * kv_stride, kv_stride, min(kBlockKV, S - kv0), hd);
  load_tile<HDP, kBlockKV>(sV, a.v + kv_off + kv0 * kv_stride, kv_stride, min(kBlockKV, S - kv0), hd);
  const int r0 = warp * 16 + g;              // this lane's keys: r0, r0 + 8
  const int ka = kv0 + r0, kb = ka + 8;
  const int32_t* valid = a.kv_valid + static_cast<long>(b) * S;
  const int va = ka < S ? valid[ka] : 0;
  const int vb = kb < S ? valid[kb] : 0;

  float dk[DBLKS][4], dv[DBLKS][4];
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long q_off = static_cast<long>(b) * T * q_stride + static_cast<long>(h) * hd;
    const long row_off = (static_cast<long>(b) * a.Hq + h) * T;
    for (int q0 = 0; q0 < T; q0 += kBlockQT) {
      __syncthreads();  // the previous query tile is consumed
      const int qrows = min(kBlockQT, T - q0);
      load_tile<HDP, kBlockQT>(sQ, a.q + q_off + q0 * q_stride, q_stride, qrows, hd);
      load_tile<HDP, kBlockQT>(sdO, a.dout + q_off + q0 * q_stride, q_stride, qrows, hd);
      if (threadIdx.x < kBlockQT) {
        const bool in = threadIdx.x < qrows;
        sLse[threadIdx.x] = in ? a.lse[row_off + q0 + threadIdx.x] : 0.f;
        sDelta[threadIdx.x] = in ? a.delta[row_off + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T and dp^T = V dO^T for this warp's 16 keys x 32 queries
      float st[NBLKS][4], dpt[NBLKS][4];
#pragma unroll
      for (int j = 0; j < NBLKS; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ak[4], av[4];
        load_a<LD>(ak, sK, r0, kk, t4);
        load_a<LD>(av, sV, r0, kk, t4);
#pragma unroll
        for (int j = 0; j < NBLKS; ++j) {
          const int off = (j * 8 + g) * LD + 2 * t4 + kk * 16;
          mma_16816(st[j], ak, lds32(sQ + off), lds32(sQ + off + 8));
          mma_16816(dpt[j], av, lds32(sdO + off), lds32(sdO + off + 8));
        }
      }

      uint32_t pf[kBlockQT / 16][4], dsf[kBlockQT / 16][4];
#pragma unroll
      for (int j = 0; j < NBLKS; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = j * 8 + 2 * t4 + e;
          const int qpos = q0 + cl;
          const bool in = qpos < T;
          const float lse = sLse[cl], del = sDelta[cl];
          p[e] = in && visible(qpos, ka, pl, va) ? expf(st[j][e] * a.scale - lse) : 0.f;
          p[2 + e] = in && visible(qpos, kb, pl, vb) ? expf(st[j][2 + e] * a.scale - lse) : 0.f;
          ds[e] = p[e] * (dpt[j][e] - del);
          ds[2 + e] = p[2 + e] * (dpt[j][2 + e] - del);
        }
        const int half = (j & 1) * 2;
        pf[j >> 1][half + 0] = pack_bf16x2(p[0], p[1]);
        pf[j >> 1][half + 1] = pack_bf16x2(p[2], p[3]);
        dsf[j >> 1][half + 0] = pack_bf16x2(ds[0], ds[1]);
        dsf[j >> 1][half + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      // dv += p^T dO, dk += ds^T Q (k = query rows of the tile)
#pragma unroll
      for (int kk = 0; kk < kBlockQT / 16; ++kk) {
        const int row = (kk * 16 + (lane & 15)) * LD;
#pragma unroll
        for (int d = 0; d < DBLKS; ++d) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, sdO + row + d * 8);
          mma_16816(dv[d], pf[kk], b0, b1);
          ldsm_x2_trans(b0, b1, sQ + row + d * 8);
          mma_16816(dk[d], dsf[kk], b0, b1);
        }
      }
    }
  }

  const float sc = a.scale;
  __nv_bfloat16* dka = a.dk + kv_off + static_cast<long>(ka) * kv_stride;
  __nv_bfloat16* dkb = a.dk + kv_off + static_cast<long>(kb) * kv_stride;
  __nv_bfloat16* dva = a.dv + kv_off + static_cast<long>(ka) * kv_stride;
  __nv_bfloat16* dvb = a.dv + kv_off + static_cast<long>(kb) * kv_stride;
#pragma unroll
  for (int d = 0; d < DBLKS; ++d) {
    const int c = d * 8 + 2 * t4;
    if (c < hd) {
      if (ka < S) {
        *reinterpret_cast<uint32_t*>(dka + c) = pack_bf16x2(sc * dk[d][0], sc * dk[d][1]);
        *reinterpret_cast<uint32_t*>(dva + c) = pack_bf16x2(dv[d][0], dv[d][1]);
      }
      if (kb < S) {
        *reinterpret_cast<uint32_t*>(dkb + c) = pack_bf16x2(sc * dk[d][2], sc * dk[d][3]);
        *reinterpret_cast<uint32_t*>(dvb + c) = pack_bf16x2(dv[d][2], dv[d][3]);
      }
    }
  }
}

enum Which { kFwd, kDq, kDkv };

template <int HDP>
int launch(Which which, const Args& a, int B, cudaStream_t stream) {
  constexpr int TILE = (HDP + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  void (*kernel)(Args);
  int smem;
  dim3 grid;
  if (which == kFwd) {
    kernel = prefix_flash_fwd_kernel<HDP>;
    smem = (kBlockQ + 2 * kBlockKV) * TILE + kBlockKV * 4;
    grid = dim3((a.T + kBlockQ - 1) / kBlockQ, a.Hq, B);
  } else if (which == kDq) {
    kernel = prefix_flash_dq_kernel<HDP>;
    smem = (2 * kBlockQ + 2 * kBlockKV) * TILE + kBlockKV * 4;
    grid = dim3((a.T + kBlockQ - 1) / kBlockQ, a.Hq, B);
  } else {
    kernel = prefix_flash_dkv_kernel<HDP>;
    smem = (2 * kBlockKV + 2 * kBlockQT) * TILE + 2 * kBlockQT * 4;
    grid = dim3((a.S + kBlockKV - 1) / kBlockKV, a.Hkv, B);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Which which, const Args& a, int B, cudaStream_t stream) {
  const int hd = a.hd;
  if (hd <= 0 || hd % 8 != 0 || hd > 128 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.T <= 0 ||
      a.S <= 0 || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the head dim is zero-padded to the next of these in shared memory
  if (hd <= 16) return launch<16>(which, a, B, stream);
  if (hd <= 32) return launch<32>(which, a, B, stream);
  if (hd <= 64) return launch<64>(which, a, B, stream);
  if (hd <= 80) return launch<80>(which, a, B, stream);
  return launch<128>(which, a, B, stream);
}

Args make_args(const void* q, const void* k, const void* v, const void* plen,
               const void* kv_valid, int T, int S, int Hq, int Hkv, int hd, float scale) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.plen = static_cast<const int32_t*>(plen);
  a.kv_valid = static_cast<const int32_t*>(kv_valid);
  a.T = T;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.scale = scale;
  return a;
}

}  // namespace

// q [B, T, Hq, hd], k/v [B, S, Hkv, hd] bf16 contiguous; plen [B] and
// kv_valid [B, S] int32; out [B, T, Hq, hd] bf16, lse [B, Hq, T] f32.
// hd % 8 == 0 and hd <= 128; Hq % Hkv == 0.  Each returns a cudaError_t.
extern "C" int lavida_prefix_flash_fwd(const void* q, const void* k, const void* v,
                                       const void* plen, const void* kv_valid, void* out,
                                       void* lse, int B, int T, int S, int Hq, int Hkv,
                                       int hd, float scale, void* stream) {
  Args a = make_args(q, k, v, plen, kv_valid, T, S, Hq, Hkv, hd, scale);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, a, B, static_cast<cudaStream_t>(stream));
}

// dout, dq [B, T, Hq, hd] bf16; lse, delta [B, Hq, T] f32.
extern "C" int lavida_prefix_flash_dq(const void* q, const void* k, const void* v,
                                      const void* plen, const void* kv_valid,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int T, int S, int Hq, int Hkv, int hd,
                                      float scale, void* stream) {
  Args a = make_args(q, k, v, plen, kv_valid, T, S, Hq, Hkv, hd, scale);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.o = static_cast<__nv_bfloat16*>(dq);
  return dispatch(kDq, a, B, static_cast<cudaStream_t>(stream));
}

// dk, dv [B, S, Hkv, hd] bf16 (every row written).
extern "C" int lavida_prefix_flash_dkv(const void* q, const void* k, const void* v,
                                       const void* plen, const void* kv_valid,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int T, int S, int Hq,
                                       int Hkv, int hd, float scale, void* stream) {
  Args a = make_args(q, k, v, plen, kv_valid, T, S, Hq, Hkv, hd, scale);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  return dispatch(kDkv, a, B, static_cast<cudaStream_t>(stream));
}
