// Decode attention over the bf16 KV cache, read in place, for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package's cached denoise step
// attends over the bf16 cache in plain XLA (or, with `use_flash`, through
// its short-attention kernel, lavida_mod_tpu/generation/diffusion.py:
// 141-179); the port ran `ops/attention.py::dense_attention` there, whose
// batched products fold the (batch, KV head) dims of the [B, S, Hkv, hd]
// buffers into one stride by copying the whole cache, K and V, every layer
// of every step.  This kernel reads the buffers where they lie.
//
// What it computes: for every batch row b and query head h = j G + g,
// o[t] = softmax(q[t] . K_j^T * scale, masked) V_j over the S rows of the
// [B, S, Hkv, hd] buffers, a key masked with the finite -1e30 where the
// [B, S] valid bytes are 0 (so a row that sees no key averages over all
// S, as dense_attention's additive bias makes it), f32 scores, the
// unnormalized p rounded to bf16 for the PV product (as kernel #1 rounds
// it), f32 accumulation, o / l at the end, bf16 out.
//
// What bounds it on the H100: the cache stream.  At the batched serving
// step ([32, 32, 32, 128] queries over 1184 keys) one launch reads 621 MB
// of K and V and 8.4 MB of q and writes 8.4 MB: 0.190 ms at 3.35 TB/s,
// against 20 us of tensor-core work.
//
// What the design does about it:
//   - A CTA is (64-row query tile, key split, batch row, KV head).  Its
//     rows are the G T query rows that read KV head j (row g T + t is
//     query head j G + g at position t): 32 at the serving step, so one
//     64-row wgmma tile and one consumer warpgroup, its rows past G T
//     zero.  Q's fragments go straight from device memory into registers
//     (the A operand of S = Q K^T), so Q takes no shared memory.
//   - One producer warp streams 64-key K and V tiles from the cache buffer
//     by TMA (4-D maps over [B, S, Hkv, hd]: the row stride is Hkv hd
//     elements, the keys past S zero-filled) into a three-stage ring, with
//     the tile's 64 mask bytes, on mbarrier pairs.  A stage is 32 KB at hd
//     128, the CTA 97 KB, so two CTAs share an SM and four stages of
//     theirs are in flight while two are consumed.
//   - The consumer takes S = Q K^T (`wgmma.m64n64k16`, Q from registers,
//     K K-major in 128-byte swizzled rows) and P V (p packed to bf16 in
//     registers, V the MN-major operand), S of tile j issued together with
//     P V of tile j - 1, and an online softmax in the log2 domain (log2 e
//     folded into the scale; -1e30 set after the fold; keys past S -inf).
//   - Key splits, chosen from the shape by `decode_plan`
//     (ops/decode_attention.py): none when the (batch row, KV head) pairs
//     fill the card (1024 of them at the serving step), a few when they do
//     not (B = 1: 32 pairs over 132 SMs).  Each split writes (m, l, O) in
//     f32 and `decode_merge_kernel`, launched under programmatic dependent
//     launch, merges them in split order.
// Kernel #1's symbol, #4's, the row quantization's and #10's are not
// matched by these kernels' names (the benchmark takes device time by
// them).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

// The plan's constants, mirrored by ops/decode_attention.py (DEC_*; a CPU
// test reads them here).
constexpr int kRows = 64;        // query rows per CTA: one consumer warpgroup
constexpr int kKeys = 64;        // keys per ring stage
constexpr int kStages = 3;
constexpr int kMaxSplits = 32;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr float kMasked = -1e30f;          // ops/attention.py's NEG_INF

// A K or V tile of kKeys rows of the head dim HD (flash::Layout): at HD 128
// two 64-column boxes in 128-byte swizzled rows, at HD 16 one 16-column box.
template <int HD>
struct Dec {
  using L = flash::Layout<HD, kKeys>;
  static constexpr int kTile = L::kTile;
  static constexpr int kSmem = 1024 + kStages * 2 * kTile;  // the ring, 1024-aligned
};

// D (64 x 64, f32) (+)= A (64 x 16 bf16, fragments in registers) * B (16 x
// 64, K-major in shared memory); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_k64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return p == nullptr ? 0u : *reinterpret_cast<const uint32_t*>(p);
}

// grid (row tiles, splits, B * Hkv); kThreads threads; Dec<HD>::kSmem bytes
// of dynamic shared memory.  Split z takes the key tiles [z per_split,
// (z + 1) per_split) of the ceil(S / kKeys).  With one split it writes out;
// with more, its (O, m, l) partials to ws (see the C entry).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tt_k,
                        const __grid_constant__ CUtensorMap tt_v,
                        const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ valid,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int T, int S,
                        int Hq, int Hkv, int per_split, float scale_log2) {
  using L = typename Dec<HD>::L;
  constexpr int TILE = Dec<HD>::kTile;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(16) uint8_t masks[kStages][kKeys];
  unsigned char* ring = flash::align1024(smem_raw);  // stage s: K at 2 s TILE, V after it

  const int rt = blockIdx.x, split = blockIdx.y, splits = gridDim.y, pair = blockIdx.z;
  const int b = pair / Hkv, j = pair % Hkv, G = Hq / Hkv, rows = G * T;
  const int tiles = (S + kKeys - 1) / kKeys;
  const int j_lo = split * per_split, j_hi = min(j_lo + per_split, tiles);
  const int n_kv = j_hi - j_lo;  // at least 1: the plan leaves no split empty

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  hopper::griddep_launch_dependents();  // the split merge may be scheduled

  if (threadIdx.x >= kConsumers) {
    // the producer warp: every lane copies two of the tile's mask bytes and
    // arrives on the stage's barrier, lane 0 with the TMA copies
    const int lane = threadIdx.x & 31;
    const uint8_t* vrow = valid == nullptr ? nullptr : valid + static_cast<long>(b) * S;
    int stage = 0, phase = 0;
    for (int jt = j_lo; jt < j_hi; ++jt) {
      const int kv0 = jt * kKeys;
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      for (int c = lane; c < kKeys; c += 32)
        masks[stage][c] = vrow == nullptr || (kv0 + c < S && vrow[kv0 + c]);
      if (lane == 0) {
        unsigned char* kt = ring + 2 * stage * TILE;
        hopper::mbar_expect_tx(&full[stage], 2 * TILE);
        flash::load_tile<HD, kKeys>(kt, &tm_k, &tt_k, &full[stage], j, kv0, b);
        flash::load_tile<HD, kKeys>(kt + TILE, &tm_v, &tt_v, &full[stage], j, kv0, b);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds rows ra and ra + 8 of the
  // tile, columns 8 c + 2 t4 (+1) of each 8-column block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int la = warp * 16 + (lane >> 2);
  const int ra = rt * kRows + la, rb = ra + 8;
  auto q_row = [&](int r) -> const __nv_bfloat16* {
    if (r >= rows) return nullptr;  // the tile's rows past G T stay zero
    return q + ((static_cast<long>(b) * T + r % T) * Hq + j * G + r / T) * HD;
  };
  const __nv_bfloat16* qa = q_row(ra);
  const __nv_bfloat16* qb = q_row(rb);
  uint32_t qf[HD / 16][4];  // Q's A fragments, k16 step kk: columns 16 kk ..
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = 16 * kk + 2 * t4;
    qf[kk][0] = load_pair(qa == nullptr ? nullptr : qa + c);
    qf[kk][1] = load_pair(qb == nullptr ? nullptr : qb + c);
    qf[kk][2] = load_pair(qa == nullptr ? nullptr : qa + c + 8);
    qf[kk][3] = load_pair(qb == nullptr ? nullptr : qb + c + 8);
  }

  float o[HD / 2], s[kKeys / 2];
  uint32_t pf[kKeys / 16][4];  // bf16 p: the A fragments of the PV product
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // S = Q K^T over the head dim, k16 steps of 32 bytes along a swizzled row
  auto qk = [&](const unsigned char* kt) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint64_t db = 0;
      if (kk < 4 * L::kMain) {
        db = flash::smem_desc<128>(kt + (kk / 4) * L::kBox + (kk % 4) * 32, 16);
      } else if constexpr (L::kTailCols > 0) {
        db = flash::smem_desc<L::kTailRow>(kt + L::kMain * L::kBox + (kk - 4 * L::kMain) * 32, 16);
      }
      wgmma_rs_k64(s, qf[kk], db, kk > 0);
    }
  };
  // the tile's scores -> p = exp2(s scale_log2 - m) in place; updates m and
  // l (from the unrounded p) and gives the factors that rescale o
  auto softmax = [&](const uint8_t* mk, int left, float& alpha0, float& alpha1) {
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
      const int c = jj * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * jj + e] * scale_log2, x1 = s[4 * jj + 2 + e] * scale_log2;
        if (c + e >= left) {
          x0 = x1 = -INFINITY;
        } else if (!mk[c + e]) {
          x0 = x1 = kMasked;
        }
        s[4 * jj + e] = x0;
        s[4 * jj + 2 + e] = x1;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key 0 of every tile lies below S, so the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = flash::ex2(m0 - mn0);
    alpha1 = flash::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
      s[4 * jj + 0] = flash::ex2(s[4 * jj + 0] - mn0);
      s[4 * jj + 1] = flash::ex2(s[4 * jj + 1] - mn0);
      s[4 * jj + 2] = flash::ex2(s[4 * jj + 2] - mn1);
      s[4 * jj + 3] = flash::ex2(s[4 * jj + 3] - mn1);
      sum0 += s[4 * jj] + s[4 * jj + 1];
      sum1 += s[4 * jj + 2] + s[4 * jj + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  };

  // tile 0: S, then its softmax; every later tile j issues S_j and
  // P_{j-1} V_{j-1} together and takes the softmax of S_j while the PV
  // product runs (the P registers stay fenced until it has finished)
  hopper::mbar_wait(&full[0], 0);
  hopper::wgmma_fence();
  qk(ring);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_acc(s);
  float alpha0, alpha1;
  softmax(masks[0], S - j_lo * kKeys, alpha0, alpha1);
  flash::pack_p<kKeys>(s, pf);
  int prev = 0, stage = 0, phase = 0;
  for (int jt = 1; jt < n_kv; ++jt) {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    hopper::mbar_wait(&full[stage], phase);
    hopper::wgmma_fence();
    qk(ring + 2 * stage * TILE);
    hopper::wgmma_commit();
    flash::pv_product<HD, kKeys, kKeys / 16>(o, pf, ring + 2 * prev * TILE + TILE, 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
    hopper::fence_acc(s);
    softmax(masks[stage], S - (j_lo + jt) * kKeys, alpha0, alpha1);
    hopper::wgmma_wait<0>();
    hopper::fence_acc(o);
    flash::fence_regs(pf);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[4 * d + 0] *= alpha0;
      o[4 * d + 1] *= alpha0;
      o[4 * d + 2] *= alpha1;
      o[4 * d + 3] *= alpha1;
    }
    flash::pack_p<kKeys>(s, pf);
    prev = stage;
  }
  hopper::wgmma_fence();
  flash::pv_product<HD, kKeys, kKeys / 16>(o, pf, ring + 2 * prev * TILE + TILE, 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_acc(o);
  flash::fence_regs(pf);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (splits == 1) {
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* oa = qa == nullptr ? nullptr : out + (qa - q);
    __nv_bfloat16* ob = qb == nullptr ? nullptr : out + (qb - q);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const int c = d * 8 + 2 * t4;
      if (oa != nullptr) {
        *reinterpret_cast<uint32_t*>(oa + c) =
            flash::pack_bf16x2(o[4 * d] * inv0, o[4 * d + 1] * inv0);
      }
      if (ob != nullptr) {
        *reinterpret_cast<uint32_t*>(ob + c) =
            flash::pack_bf16x2(o[4 * d + 2] * inv1, o[4 * d + 3] * inv1);
      }
    }
    return;
  }
  // this split's partials: O rows [part][kRows][HD], then (m, l) [part][kRows][2]
  const long part = (static_cast<long>(pair) * gridDim.x + rt) * splits + split;
  const long parts = static_cast<long>(gridDim.x) * splits * gridDim.z;
  float* wo = ws + part * kRows * HD;
  float* ml = ws + parts * kRows * HD + part * kRows * 2;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int c = d * 8 + 2 * t4;
    if (ra < rows) *reinterpret_cast<float2*>(wo + la * HD + c) = make_float2(o[4 * d], o[4 * d + 1]);
    if (rb < rows) {
      *reinterpret_cast<float2*>(wo + (la + 8) * HD + c) = make_float2(o[4 * d + 2], o[4 * d + 3]);
    }
  }
  if (t4 == 0) {
    ml[la * 2] = m0;
    ml[la * 2 + 1] = l0;
    ml[(la + 8) * 2] = m1;
    ml[(la + 8) * 2 + 1] = l1;
  }
}

// Merges the key splits of each (batch row, KV head, row tile) in split
// order: m = max m_c, l = sum l_c exp2(m_c - m), out = sum O_c exp2(m_c -
// m) / l (log2 domain, as the partials hold m).  One thread per 4 output
// columns of a row; block x is the (batch row, KV head, row tile), block y
// a slice of its rows.
__global__ void __launch_bounds__(128)
decode_merge_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int T, int Hq,
                    int Hkv, int hd, int row_tiles, int splits, long ml_off) {
  hopper::griddep_wait();  // the partials of the kernel before
  const int unit = blockIdx.x, rt = unit % row_tiles, pair = unit / row_tiles;
  const int b = pair / Hkv, j = pair % Hkv, G = Hq / Hkv;
  const int quads = hd / 4;
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  const int rl = idx / quads, d = (idx % quads) * 4;
  const int r = rt * kRows + rl;
  if (rl >= kRows || r >= G * T) return;
  const long base = static_cast<long>(unit) * splits;  // split 0's partial
  const float* ml = ws + ml_off;
  float m = -INFINITY;
  for (int c = 0; c < splits; ++c) m = fmaxf(m, ml[((base + c) * kRows + rl) * 2]);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < splits; ++c) {
    const long row = (base + c) * kRows + rl;
    const float e = exp2f(ml[row * 2] - m);
    l += ml[row * 2 + 1] * e;
    const float4 x = *reinterpret_cast<const float4*>(ws + row * hd + d);
    o.x += x.x * e;
    o.y += x.y * e;
    o.z += x.z * e;
    o.w += x.w * e;
  }
  const float inv = 1.f / l;
  __nv_bfloat16* dst = out + ((static_cast<long>(b) * T + r % T) * Hq + j * G + r / T) * hd + d;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(flash::pack_bf16x2(o.x * inv, o.y * inv), flash::pack_bf16x2(o.z * inv, o.w * inv));
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, void* out, float* ws,
           int B, int T, int S, int Hq, int Hkv, float scale, int row_tiles, int splits,
           int per_split, cudaStream_t st) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];  // K's and V's 64-column boxes, then their tail boxes
  if (!flash::encode_tile_maps<HD>(&maps[0], &maps[2], k, B, S, Hkv, HD, kKeys) ||
      !flash::encode_tile_maps<HD>(&maps[1], &maps[3], v, B, S, Hkv, HD, kKeys))
    return kBad;
  static int allowed = 0;
  int err = hopper::allow_smem(decode_attention_kernel<HD>, Dec<HD>::kSmem, allowed);
  if (err) return err;
  decode_attention_kernel<HD><<<dim3(row_tiles, splits, B * Hkv), kThreads, Dec<HD>::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const __nv_bfloat16*>(q), valid,
      static_cast<__nv_bfloat16*>(out), ws, T, S, Hq, Hkv, per_split, scale * flash::kLog2e);
  err = static_cast<int>(cudaGetLastError());
  if (err || splits == 1) return err;
  const int units = B * Hkv * row_tiles;
  err = hopper::launch_dependent(decode_merge_kernel, dim3(units, (kRows * HD / 4 + 127) / 128),
                                 dim3(128), 0, st, static_cast<const float*>(ws),
                                 static_cast<__nv_bfloat16*>(out), T, Hq, Hkv, HD, row_tiles,
                                 splits, static_cast<long>(units) * splits * kRows * HD);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, T, Hq, hd] bf16; k, v [B, S, Hkv, hd] bf16 (the cache buffers);
// valid [B, S] bool (one byte a key) or null (every key valid); out [B, T,
// Hq, hd] bf16; all contiguous and 16-byte aligned.  hd 128 (LLaDA-8B,
// Dream-7B) or 16 (the tiny test models): the head dims a configuration
// of this repo has; Hq a multiple of Hkv.  The plan (row_tiles, splits) is
// decode_plan's: row_tiles = ceil(Hq / Hkv * T / 64), splits of at most
// kMaxSplits, none empty; ws, with more than one split, f32 [B Hkv
// row_tiles splits, 64, hd] partial O then [.., 64, 2] (m, l).  Returns a
// cudaError_t.
extern "C" int lavida_decode_attention(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, void* ws, int B, int T,
                                       int Hq, int Hkv, int S, int hd, float scale, int row_tiles,
                                       int splits, void* stream) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || (hd != 16 && hd != 128) ||
      static_cast<long>(B) * Hkv > 65535)
    return kBad;
  const int rows = Hq / Hkv * T, tiles = (S + kKeys - 1) / kKeys;
  const int per_split = splits > 0 ? (tiles + splits - 1) / splits : 0;
  if (row_tiles != (rows + kRows - 1) / kRows || splits < 1 || splits > kMaxSplits ||
      splits > tiles || (splits - 1) * per_split >= tiles || (splits > 1 && ws == nullptr))
    return kBad;
  for (const void* p : {q, k, v, static_cast<const void*>(out), static_cast<const void*>(ws)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kBad;
  const auto* vb = static_cast<const uint8_t*>(valid);
  auto* wf = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  if (hd == 16)
    return launch<16>(q, k, v, vb, out, wf, B, T, S, Hq, Hkv, scale, row_tiles, splits, per_split, st);
  return launch<128>(q, k, v, vb, out, wf, B, T, S, Hq, Hkv, scale, row_tiles, splits, per_split, st);
}
