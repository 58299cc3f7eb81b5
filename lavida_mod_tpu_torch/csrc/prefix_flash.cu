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
//     softmax over K/V tiles with the rescale guarded as alpha = exp(min(
//     m_prev - m_new, 0)); p = exp(s - m) summed in f32 and rounded to v's
//     type before the PV product; o = acc / max(l, 1e-30) and lse = m +
//     log(max(l, 1e-30)) [B, Hq, T] f32, in natural log.
//   dq:  p = visible ? exp(s - lse) : 0, dp = dO . V^T, ds = p * (dp - delta),
//        dq = scale * bf16(ds) @ K, with delta = sum(dO * o) over hd computed
//        outside (ops/prefix_flash.py);
//   dkv: dv = bf16(p)^T @ dO and dk = scale * bf16(ds)^T @ Q, summed over the
//        GQA group's q heads and all query tiles.
// The kernels work in exp2 with log2(e) folded into the score scale; lse is
// read and written in natural log.  A row whose first K/V tile holds no
// visible key sums exp(0) = 1 for that tile's masked keys until a visible
// key's max clears them through alpha = 0, as the TPU kernel does.  Keys
// past S (the ragged edge) get -inf and never enter a sum: the TPU wrapper
// pads S to its 512 block with masked keys instead, which only differs for
// a row with no visible key at all (it averages v over the S real keys
// here).
//
// What bounds it on the H100: at the stage-1 training shape (8 rows of 1152
// tokens, 32 heads, hd 128, plen near 1010, about 1058 valid keys) every
// kernel is tensor-core math on tiles that come from L2 (4 / 6 / 8 x the
// visible (query, key) pairs x Hq x hd operations for fwd / dq / dkv, 87 %
// of all pairs), so it is compute-bound when the tensor cores are fed.
//
// What the design does about it (the Hopper notes, as kernel #1): every
// kernel is warp-specialized, a producer warpgroup whose one working warp
// keeps TMA copies in flight through an mbarrier ring (giving its
// registers to the consumers with `setmaxnreg` 24 / 240; kernels.py holds
// every instance at the 168 registers that needs) and two consumer
// warpgroups that issue wgmma, each owning 64 rows of the CTA's 128.
//   - forward: the pipeline of csrc/flash_attention.cuh (kernel #1's), with
//     the prefix-LM mask read from one int per key copied per tile and the
//     lse store: S = Q K^T (SS) and O += P V (RS, p from registers); S_j
//     issued with P_{j-1} V_{j-1}; ping-pong on named barriers.
//   - dq: a CTA per (128 query rows, q head, batch row) holds its Q and dO
//     tiles and its rows' lse and delta, and streams 128-key K/V tiles
//     through a two-stage ring, in halves of 64 keys: S = Q K^T and dP =
//     dO V^T (both SS, m64n64), dS = P (dP - delta) in registers, dQ += dS K
//     (RS: bf16(dS) from registers, K the MN-major B operand through the
//     transpose bit, as the forward feeds V).  The products of half u are
//     issued with dQ's product of half u - 1, and the two warpgroups
//     ping-pong as in the forward.
//   - dkv: a CTA per (128-key tile, kv head, batch row); each consumer
//     warpgroup owns 64 keys with K and V resident in shared memory, and
//     the producer streams 64-row Q and dO tiles of each of the group's q
//     heads through a four-stage ring, with their lse, delta and prefix
//     levels.  S^T = K Q^T and dP^T = V dO^T (both SS) leave P^T and dS^T
//     in registers in the A layout, so dV += bf16(P^T) dO and dK +=
//     bf16(dS^T) Q are RS products.  dK and dV accumulate in registers over
//     the whole group and every query tile: no atomics, deterministic.
//   - exact tile skipping: the forward and dq visit only the K/V tiles from
//     the first valid key to the last (to plen when every row of the CTA
//     lies inside the prefix), the forward all of them when one of its rows
//     sees no key (csrc/flash_attention.cuh); dkv visits only the query
//     tiles that can see its keys (from plen's tile on when every key lies
//     at or past plen, none when no key is valid), and a key tile that no
//     row sees writes zeros.  Skipped tiles contribute exactly 0.
// The tiles' head dim is copied as 64-column boxes plus a narrow tail box
// (flash::Layout); ragged T and S are zero-filled by TMA and masked in the
// kernel, and q/k/v are read in their [B, T, H, hd] layout.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using namespace flash;

constexpr int kDqStages = 2;   // dq: 128-key K/V tiles in flight
constexpr int kQRows = 64;     // dkv: query rows per streamed tile
constexpr int kDkvStages = 4;  // dkv: Q/dO tiles in flight

// The forward's arguments, as the launcher gathers them (flash_fwd).
struct FwdArgs {
  const int32_t* q_side;    // plen [B]
  const int32_t* kv_side;   // kv_valid [B, S]
  __nv_bfloat16* out;       // [B, T, Hq, hd]
  float* lse;               // [B, Hq, T]
  int T, S, Hq, Hkv, hd;
  float scale_log2;
};

struct BwdArgs {
  const int32_t* plen;      // [B]
  const int32_t* kv_valid;  // [B, S]
  const float* lse;         // [B, Hq, T]
  const float* delta;       // [B, Hq, T]
  __nv_bfloat16* dq;        // [B, T, Hq, hd]
  __nv_bfloat16* dk;        // [B, S, Hkv, hd]
  __nv_bfloat16* dv;        // [B, S, Hkv, hd]
  int T, S, Hq, Hkv, hd;
  float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// forward: grid (ceil(T / 128), Hq, B)
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
prefix_flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tt_q,
                        const __grid_constant__ CUtensorMap tt_k,
                        const __grid_constant__ CUtensorMap tt_v,
                        const int32_t* __restrict__ plen, const int32_t* __restrict__ kv_valid,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int S,
                        int Hq, int Hkv, int hd, float scale_log2) {
  flash_fwd<HDP, true>(&tm_q, &tm_k, &tm_v, &tt_q, &tt_k, &tt_v, plen, kv_valid, out, lse, T, S, Hq,
                       Hkv, hd, scale_log2);
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(T / 128), Hq, B); maps q, k, v, dout (128-row boxes),
// then their tail boxes
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
prefix_flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tt_q,
                       const __grid_constant__ CUtensorMap tt_k,
                       const __grid_constant__ CUtensorMap tt_v,
                       const __grid_constant__ CUtensorMap tt_do, const __grid_constant__ BwdArgs a) {
  using L = Layout<HDP>;
  constexpr int TILE = L::kTile;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kDqStages], empty[kDqStages];
  __shared__ __align__(16) int32_t codes[kDqStages][kBN];
  __shared__ int key_range[2];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + TILE;
  unsigned char* sKV = sdO + TILE;  // stage s: K at 2 s TILE, V at (2 s + 1) TILE

  const int T = a.T, S = a.S;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int hk = h / (a.Hq / a.Hkv);
  const int plen = a.plen[b];
  const int32_t* valid = a.kv_valid + static_cast<long>(b) * S;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    key_range[0] = S;
    key_range[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the K/V tiles that hold a key one of this CTA's rows sees; the others
  // add p = 0
  const int2 tiles =
      prefix_tiles(valid_key_range(valid, S, key_range), plen, q0, min(q0 + kBM, T));
  const int n_kv = tiles.y - tiles.x;

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32 || n_kv == 0) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(&q_full, 2 * TILE);
      load_tile<HDP, kBM>(sQ, &tm_q, &tt_q, &q_full, h, q0, b);
      load_tile<HDP, kBM>(sdO, &tm_do, &tt_do, &q_full, h, q0, b);
    }
    int stage = 0, phase = 0;
    for (int j = tiles.x; j < tiles.y; ++j) {
      const int kv0 = j * kBN;
      mbar_wait(&empty[stage], phase ^ 1);
      for (int c = lane; c < kBN; c += 32) codes[stage][c] = prefix_code(valid, kv0 + c, S, plen);
      if (lane == 0) {
        unsigned char* k = sKV + 2 * stage * TILE;
        mbar_expect_tx(&full[stage], 2 * TILE);
        load_tile<HDP, kBN>(k, &tm_k, &tt_k, &full[stage], hk, kv0, b);
        load_tile<HDP, kBN>(k + TILE, &tm_v, &tt_v, &full[stage], hk, kv0, b);
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kDqStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int ta = q0 + wg * 64 + warp * 16 + (lane >> 2), tb = ta + 8;
  // a key with mask int c is visible from a row at level c or above; rows
  // past T see nothing
  const int lvl0 = ta < T ? (ta >= plen) : -1, lvl1 = tb < T ? (tb >= plen) : -1;
  const long row_off = (static_cast<long>(b) * a.Hq + h) * T;
  const float lse0 = ta < T ? a.lse[row_off + ta] * kLog2e : 0.f;
  const float lse1 = tb < T ? a.lse[row_off + tb] * kLog2e : 0.f;
  const float del0 = ta < T ? a.delta[row_off + ta] : 0.f;
  const float del1 = tb < T ? a.delta[row_off + tb] : 0.f;
  const float scale_log2 = a.scale_log2;

  float dq[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
  if (n_kv > 0) {
    float s[32], dp[32];
    uint32_t dsf[4][4];  // bf16 dS: the A fragments of dQ's product
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(&q_full, 0);
    const unsigned char* q_wg = sQ + wg * 64 * 128;
    const unsigned char* q_tail = sQ + L::kMain * L::kBox + wg * 64 * L::kTailRow;
    const unsigned char* do_wg = sdO + wg * 64 * 128;
    const unsigned char* do_tail = sdO + L::kMain * L::kBox + wg * 64 * L::kTailRow;
    // S = Q K_h^T and dP = dO V_h^T over the keys [64 h, 64 h + 64) of a tile
    auto products = [&](const unsigned char* k, int half) {
      const unsigned char* v = k + TILE;
      const int r = half * 64;
      qk_product<HDP, 64>(s, q_wg, q_tail, L::kBox, k + r * 128,
                          k + L::kMain * L::kBox + r * L::kTailRow, L::kBox);
      qk_product<HDP, 64>(dp, do_wg, do_tail, L::kBox, v + r * 128,
                          v + L::kMain * L::kBox + r * L::kTailRow, L::kBox);
    };
    // s <- dS = p (dp - delta), p = visible ? exp2(s scale log2 e - lse
    // log2 e) : 0, over 64 keys from kv0 whose mask ints are `code`
    auto grad = [&](const int32_t* code, int kv0) {
      const int in = S - kv0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = jj * 8 + 2 * t4;
        const int2 kc = *reinterpret_cast<const int2*>(code + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int code_e = e ? kc.y : kc.x;
          const bool ok = c + e < in;
          const float p0 = ok && code_e <= lvl0 ? ex2(s[4 * jj + e] * scale_log2 - lse0) : 0.f;
          const float p1 =
              ok && code_e <= lvl1 ? ex2(s[4 * jj + 2 + e] * scale_log2 - lse1) : 0.f;
          s[4 * jj + e] = p0 * (dp[4 * jj + e] - del0);
          s[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - del1);
        }
      }
    };
    // dQ += dS K_h: K MN-major, 16 keys a k16 step
    auto dsk = [&](const unsigned char* k, int half) {
      pv_product<HDP, kBN, 4>(dq, dsf, k, half * 64);
    };

    // half-tile 0; then every half u issues its S and dP with dQ's product
    // of half u - 1 and computes its dS while that product runs
    if (wg == 1) turn_pass(wg);
    mbar_wait(&full[0], 0);
    turn_wait(wg);
    wgmma_fence();
    products(sKV, 0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    grad(codes[0], tiles.x * kBN);
    pack_p<64>(s, dsf);
    int stage = 0, phase = 0, prev = 0, prev_half = 0;
    for (int u = 1; u < 2 * n_kv; ++u) {
      const int half = u & 1;
      if (half == 0) {
        if (++stage == kDqStages) {
          stage = 0;
          phase ^= 1;
        }
        mbar_wait(&full[stage], phase);
      }
      turn_wait(wg);
      wgmma_fence();
      products(sKV + 2 * stage * TILE, half);
      wgmma_commit();
      dsk(sKV + 2 * prev * TILE, prev_half);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // S and dP of half u are in; dQ's product may run
      fence_acc(s);
      fence_acc(dp);
      grad(codes[stage] + half * 64, (tiles.x + u / 2) * kBN + half * 64);
      wgmma_wait<0>();
      fence_acc(dq);
      fence_regs(dsf);
      if (prev_half == 1 && lane == 0) mbar_arrive(&empty[prev]);
      pack_p<64>(s, dsf);
      prev = stage;
      prev_half = half;
    }
    turn_wait(wg);
    wgmma_fence();
    dsk(sKV + 2 * prev * TILE, prev_half);
    wgmma_commit();
    if (wg == 0) turn_pass(wg);  // as many passes each way as waits
    wgmma_wait<0>();
    fence_acc(dq);
    fence_regs(dsf);
  }

  const int hd = a.hd;
  const long q_stride = static_cast<long>(a.Hq) * hd;
  __nv_bfloat16* oa = a.dq + (static_cast<long>(b) * T + ta) * q_stride + static_cast<long>(h) * hd;
  __nv_bfloat16* ob = oa + 8 * q_stride;
  const float sc = a.scale;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const int c = d * 8 + 2 * t4;
    if (d * 8 < hd) {  // hd % 8 == 0: the pair c, c + 1 is in range together
      if (ta < T) *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16x2(sc * dq[4 * d], sc * dq[4 * d + 1]);
      if (tb < T) {
        *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16x2(sc * dq[4 * d + 2], sc * dq[4 * d + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv: grid (ceil(S / 128), Hkv, B); maps k, v (128-row boxes), q,
// dout (64-row boxes), then their tail boxes.  The products run
// transposed: rows are keys, columns queries.
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
prefix_flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tt_k,
                        const __grid_constant__ CUtensorMap tt_v,
                        const __grid_constant__ CUtensorMap tt_q,
                        const __grid_constant__ CUtensorMap tt_do, const __grid_constant__ BwdArgs a) {
  using LK = Layout<HDP, kBN>;
  using LQ = Layout<HDP, kQRows>;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[kDkvStages], empty[kDkvStages];
  __shared__ __align__(16) float lse2s[kDkvStages][kQRows];
  __shared__ __align__(16) float dels[kDkvStages][kQRows];
  __shared__ __align__(16) int32_t lvls[kDkvStages][kQRows];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + LK::kTile;
  unsigned char* sRing = sV + LK::kTile;  // stage s: Q at 2 s QT, dO at (2 s + 1) QT

  const int T = a.T, S = a.S;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBN;
  const int G = a.Hq / a.Hkv;
  const int plen = a.plen[b];
  const int32_t* valid = a.kv_valid + static_cast<long>(b) * S;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // does any key of the tile hold kv_valid?  (also the barrier after init)
  const int kc = k0 + static_cast<int>(threadIdx.x);
  const bool any = __syncthreads_or(threadIdx.x < kBN && kc < S && valid[kc]);
  // the query tiles that see a key of the tile: from plen's tile on when
  // every key lies at or past plen, none when no key is valid
  const int nq = (T + kQRows - 1) / kQRows;
  const int q_lo = !any ? nq : k0 >= plen ? min(plen / kQRows, nq) : 0;
  const int per_head = nq - q_lo;
  const int n_units = G * per_head;

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32 || n_units == 0) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(&kv_full, 2 * LK::kTile);
      load_tile<HDP, kBN>(sK, &tm_k, &tt_k, &kv_full, hk, k0, b);
      load_tile<HDP, kBN>(sV, &tm_v, &tt_v, &kv_full, hk, k0, b);
    }
    int stage = 0, phase = 0;
    for (int u = 0; u < n_units; ++u) {
      const int h = hk * G + u / per_head;
      const int qr0 = (q_lo + u % per_head) * kQRows;
      const long row_off = (static_cast<long>(b) * a.Hq + h) * T;
      mbar_wait(&empty[stage], phase ^ 1);
      for (int c = lane; c < kQRows; c += 32) {
        const int q = qr0 + c;
        const bool in = q < T;
        lse2s[stage][c] = in ? a.lse[row_off + q] * kLog2e : 0.f;
        dels[stage][c] = in ? a.delta[row_off + q] : 0.f;
        lvls[stage][c] = in ? (q >= plen) : -1;  // rows past T see nothing
      }
      if (lane == 0) {
        unsigned char* q = sRing + 2 * stage * LQ::kTile;
        mbar_expect_tx(&full[stage], 2 * LQ::kTile);
        load_tile<HDP, kQRows>(q, &tm_q, &tt_q, &full[stage], h, qr0, b);
        load_tile<HDP, kQRows>(q + LQ::kTile, &tm_do, &tt_do, &full[stage], h, qr0, b);
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kDkvStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63; this
  // thread holds keys ka and ka + 8 of them, queries 8 j + 2 t4 (+1)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int ka = k0 + wg * 64 + warp * 16 + (lane >> 2), kb = ka + 8;
  const int code_a = prefix_code(valid, ka, S, plen), code_b = prefix_code(valid, kb, S, plen);

  float dk[HDP / 2], dv[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_units > 0) {
    float st[32], dpt[32];
    uint32_t pf[4][4], dsf[4][4];  // bf16 P^T and dS^T: A fragments
    mbar_wait(&kv_full, 0);
    const unsigned char* k_wg = sK + wg * 64 * 128;
    const unsigned char* k_tail = sK + LK::kMain * LK::kBox + wg * 64 * LK::kTailRow;
    const unsigned char* v_wg = sV + wg * 64 * 128;
    const unsigned char* v_tail = sV + LK::kMain * LK::kBox + wg * 64 * LK::kTailRow;
    int stage = 0, phase = 0;
    for (int u = 0; u < n_units; ++u) {
      mbar_wait(&full[stage], phase);
      const unsigned char* q = sRing + 2 * stage * LQ::kTile;
      const unsigned char* dout = q + LQ::kTile;
      // S^T = K Q^T, dP^T = V dO^T
      wgmma_fence();
      qk_product<HDP, kQRows, true>(st, k_wg, k_tail, LK::kBox, q, q + LQ::kMain * LQ::kBox,
                                    LQ::kBox);
      qk_product<HDP, kQRows, true>(dpt, v_wg, v_tail, LK::kBox, dout,
                                    dout + LQ::kMain * LQ::kBox, LQ::kBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      // P^T and dS^T: per column (query) its lse, delta and level
#pragma unroll
      for (int jj = 0; jj < kQRows / 8; ++jj) {
        const int c = jj * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(&lse2s[stage][c]);
        const float2 dl = *reinterpret_cast<const float2*>(&dels[stage][c]);
        const int2 lv = *reinterpret_cast<const int2*>(&lvls[stage][c]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lse = e ? l2.y : l2.x, del = e ? dl.y : dl.x;
          const int lvl = e ? lv.y : lv.x;
          const float pa = code_a <= lvl ? ex2(st[4 * jj + e] * a.scale_log2 - lse) : 0.f;
          const float pb = code_b <= lvl ? ex2(st[4 * jj + 2 + e] * a.scale_log2 - lse) : 0.f;
          st[4 * jj + e] = pa;
          st[4 * jj + 2 + e] = pb;
          dpt[4 * jj + e] = pa * (dpt[4 * jj + e] - del);
          dpt[4 * jj + 2 + e] = pb * (dpt[4 * jj + 2 + e] - del);
        }
      }
      pack_p<kQRows>(st, pf);
      pack_p<kQRows>(dpt, dsf);
      // dV += P^T dO, dK += dS^T Q: dO and Q MN-major, 16 queries a step
      wgmma_fence();
      pv_product<HDP, kQRows, kQRows / 16>(dv, pf, dout, 0);
      pv_product<HDP, kQRows, kQRows / 16>(dk, dsf, q, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
      fence_regs(pf);
      fence_regs(dsf);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kDkvStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  const int hd = a.hd;
  const long kv_stride = static_cast<long>(a.Hkv) * hd;
  const long off_a = (static_cast<long>(b) * S + ka) * kv_stride + static_cast<long>(hk) * hd;
  const long off_b = off_a + 8 * kv_stride;
  const float sc = a.scale;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const int c = d * 8 + 2 * t4;
    if (d * 8 < hd) {
      if (ka < S) {
        *reinterpret_cast<uint32_t*>(a.dk + off_a + c) = pack_bf16x2(sc * dk[4 * d], sc * dk[4 * d + 1]);
        *reinterpret_cast<uint32_t*>(a.dv + off_a + c) = pack_bf16x2(dv[4 * d], dv[4 * d + 1]);
      }
      if (kb < S) {
        *reinterpret_cast<uint32_t*>(a.dk + off_b + c) =
            pack_bf16x2(sc * dk[4 * d + 2], sc * dk[4 * d + 3]);
        *reinterpret_cast<uint32_t*>(a.dv + off_b + c) = pack_bf16x2(dv[4 * d + 2], dv[4 * d + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kernel>
int configure(Kernel kernel, int smem, bool& configured) {
  if (configured) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

struct Tensors {
  const void *q, *k, *v, *dout;
  int B, T, S, Hq, Hkv, hd;
};

template <int HDP>
int launch_fwd(const Tensors& t, const FwdArgs& a, cudaStream_t stream) {
  constexpr int smem = (1 + 2 * kStages) * Layout<HDP>::kTile + 1024;
  static bool configured = false;
  if (const int err = configure(prefix_flash_fwd_kernel<HDP>, smem, configured)) return err;
  CUtensorMap maps[6];  // q, k, v; then the tail boxes
  const void* base[3] = {t.q, t.k, t.v};
  const int rows[3] = {t.T, t.S, t.S}, heads[3] = {t.Hq, t.Hkv, t.Hkv};
  for (int i = 0; i < 3; ++i) {
    if (!encode_tile_maps<HDP>(&maps[i], &maps[3 + i], base[i], t.B, rows[i], heads[i], t.hd)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((t.T + kBM - 1) / kBM, t.Hq, t.B);
  prefix_flash_fwd_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.q_side, a.kv_side, a.out, a.lse, a.T,
      a.S, a.Hq, a.Hkv, a.hd, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_dq(const Tensors& t, const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = (2 + 2 * kDqStages) * Layout<HDP>::kTile + 1024;
  static bool configured = false;
  if (const int err = configure(prefix_flash_dq_kernel<HDP>, smem, configured)) return err;
  CUtensorMap maps[8];  // q, k, v, dout; then the tail boxes
  const void* base[4] = {t.q, t.k, t.v, t.dout};
  const int rows[4] = {t.T, t.S, t.S, t.T}, heads[4] = {t.Hq, t.Hkv, t.Hkv, t.Hq};
  for (int i = 0; i < 4; ++i) {
    if (!encode_tile_maps<HDP>(&maps[i], &maps[4 + i], base[i], t.B, rows[i], heads[i], t.hd)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((t.T + kBM - 1) / kBM, t.Hq, t.B);
  prefix_flash_dq_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_dkv(const Tensors& t, const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem =
      2 * Layout<HDP, kBN>::kTile + 2 * kDkvStages * Layout<HDP, kQRows>::kTile + 1024;
  static bool configured = false;
  if (const int err = configure(prefix_flash_dkv_kernel<HDP>, smem, configured)) return err;
  CUtensorMap maps[8];  // k, v (128-row boxes), q, dout (64-row boxes); then the tails
  const void* base[4] = {t.k, t.v, t.q, t.dout};
  const int rows[4] = {t.S, t.S, t.T, t.T}, heads[4] = {t.Hkv, t.Hkv, t.Hq, t.Hq};
  const int box[4] = {kBN, kBN, kQRows, kQRows};
  for (int i = 0; i < 4; ++i) {
    if (!encode_tile_maps<HDP>(&maps[i], &maps[4 + i], base[i], t.B, rows[i], heads[i], t.hd,
                               box[i])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((t.S + kBN - 1) / kBN, t.Hkv, t.B);
  prefix_flash_dkv_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], a);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd, kDq, kDkv };

template <int HDP>
int launch(Which which, const Tensors& t, const FwdArgs& f, const BwdArgs& g,
           cudaStream_t stream) {
  if (which == kFwd) return launch_fwd<HDP>(t, f, stream);
  if (which == kDq) return launch_dq<HDP>(t, g, stream);
  return launch_dkv<HDP>(t, g, stream);
}

int dispatch(Which which, const Tensors& t, const FwdArgs& f, const BwdArgs& g,
             cudaStream_t stream) {
  const int hd = t.hd;
  if (hd <= 0 || hd % 8 != 0 || hd > 128 || t.Hkv <= 0 || t.Hq % t.Hkv != 0 || t.T <= 0 ||
      t.S <= 0 || t.B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the head dim as a tile layout: 16, 32 and 80, 96 end in a narrow box;
  // the columns up to the next of these are TMA zero fill
  if (hd <= 16) return launch<16>(which, t, f, g, stream);
  if (hd <= 32) return launch<32>(which, t, f, g, stream);
  if (hd <= 64) return launch<64>(which, t, f, g, stream);
  if (hd <= 80) return launch<80>(which, t, f, g, stream);
  if (hd <= 96) return launch<96>(which, t, f, g, stream);
  return launch<128>(which, t, f, g, stream);
}

BwdArgs bwd_args(const void* plen, const void* kv_valid, const void* lse, const void* delta,
                 int T, int S, int Hq, int Hkv, int hd, float scale) {
  BwdArgs a{};
  a.plen = static_cast<const int32_t*>(plen);
  a.kv_valid = static_cast<const int32_t*>(kv_valid);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.T = T;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return a;
}

}  // namespace

// q [B, T, Hq, hd], k/v [B, S, Hkv, hd] bf16, contiguous and 16-byte
// aligned; plen [B] and kv_valid [B, S] int32; out [B, T, Hq, hd] bf16, lse
// [B, Hq, T] f32.  hd % 8 == 0 and hd <= 128; Hq % Hkv == 0.  Each returns
// a cudaError_t.
extern "C" int lavida_prefix_flash_fwd(const void* q, const void* k, const void* v,
                                       const void* plen, const void* kv_valid, void* out,
                                       void* lse, int B, int T, int S, int Hq, int Hkv,
                                       int hd, float scale, void* stream) {
  FwdArgs f{};
  f.q_side = static_cast<const int32_t*>(plen);
  f.kv_side = static_cast<const int32_t*>(kv_valid);
  f.out = static_cast<__nv_bfloat16*>(out);
  f.lse = static_cast<float*>(lse);
  f.T = T;
  f.S = S;
  f.Hq = Hq;
  f.Hkv = Hkv;
  f.hd = hd;
  f.scale_log2 = scale * kLog2e;
  return dispatch(kFwd, Tensors{q, k, v, nullptr, B, T, S, Hq, Hkv, hd}, f, BwdArgs{},
                  static_cast<cudaStream_t>(stream));
}

// dout, dq [B, T, Hq, hd] bf16; lse, delta [B, Hq, T] f32.
extern "C" int lavida_prefix_flash_dq(const void* q, const void* k, const void* v,
                                      const void* plen, const void* kv_valid,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int T, int S, int Hq, int Hkv, int hd,
                                      float scale, void* stream) {
  BwdArgs g = bwd_args(plen, kv_valid, lse, delta, T, S, Hq, Hkv, hd, scale);
  g.dq = static_cast<__nv_bfloat16*>(dq);
  return dispatch(kDq, Tensors{q, k, v, dout, B, T, S, Hq, Hkv, hd}, FwdArgs{}, g,
                  static_cast<cudaStream_t>(stream));
}

// dk, dv [B, S, Hkv, hd] bf16 (every row written).
extern "C" int lavida_prefix_flash_dkv(const void* q, const void* k, const void* v,
                                       const void* plen, const void* kv_valid,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int T, int S, int Hq,
                                       int Hkv, int hd, float scale, void* stream) {
  BwdArgs g = bwd_args(plen, kv_valid, lse, delta, T, S, Hq, Hkv, hd, scale);
  g.dk = static_cast<__nv_bfloat16*>(dk);
  g.dv = static_cast<__nv_bfloat16*>(dv);
  return dispatch(kDkv, Tensors{q, k, v, dout, B, T, S, Hq, Hkv, hd}, FwdArgs{}, g,
                  static_cast<cudaStream_t>(stream));
}
