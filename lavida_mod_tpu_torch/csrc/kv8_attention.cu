// Decode attention over an int8 or int4 KV cache, for Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/kv8_attention.py::kv8_decode_attention (the
// Pallas kernel of the --kv8 and --kv4 decode): softmax(q k8^T * (k_scale *
// sm_scale)) (p * v_scale) v8 over a head-major cache k8/v8 [B, Hkv, S, hd]
// of int8 codes, or of int4 codes packed two a byte ([B, Hkv, S, hd / 2]
// bytes, code 2i in the low nibble of byte i, as the JAX package's pack_w4
// orders them), with per-(head, position) scales ks/vs [B, Hkv, 1, S];
// masked keys score -1e30 (not -inf), so a row that sees no valid key
// averages over all S; p * v_scale is rounded to bf16 before the PV
// product; query head j*G+g reads KV head j.
//
// What bounds it on the H100: the cache stream.  Decode attention does
// about 64 flops per byte of cache, far under the ~295 at which the tensor
// cores become the limit.  At B = 4, the bench image (S = 1184) and
// LLaDA-8B's 32 heads of 128, one launch reads 38.8 MB of int8 K/V and 1.2
// MB of scales: 12 us at 3.35 TB/s.
//
// The int4 cache halves those bytes: 19.4 MB of K/V at that shape, 6.8 us.
//
// What the design does: it reads each (batch row, KV head)'s cache once, on
// tensor cores, with an online softmax over key tiles, so any S is taken.
//   - A unit (CTA) is (batch row b, KV head j, row block, key chunk).  Its
//     rows are the G*T query rows that share head j (row g*T + t is query
//     head j*G+g at position t), cut into 16-row tiles (at most 8 per unit,
//     4 at hd 256); its keys are a chunk of the 128-key tiles of S.
//     `kv8_plan` (ops/kv8_attention.py) picks the row tiles, the key splits,
//     the chunks and the ring stages; the constants below mirror it and the
//     entry point refuses a plan that does not match.
//   - Warp w takes row tile w % row_tiles and, of every tile of keys, the
//     32-key groups w / row_tiles, + splits, ... (none past S).  A ring of 2
//     stages in shared memory holds tiles: K and V by TMA ([128 keys, row]
//     byte boxes of up to 128 bytes a row, in the swizzle of that width,
//     zero-filled past S; an int4 row of hd 16 is 8 bytes, under TMA's
//     16-byte minimum, so those rows come by 8-byte cp.async and nothing is
//     loaded past S), ks, vs and the mask bytes by 4-byte cp.async
//     (TMA would need 16-byte strides, and S * 4 is not one for every S),
//     all on the stage's mbarrier.  No warp only copies: the last warp to
//     leave a slot (a count in shared memory) refills it with the tile two
//     on.
//   - Q's fragments are loaded once into registers.  `mma.sync.m16n8k16`
//     bf16 with f32 accumulators computes S = Q K^T over four n8 tiles of
//     keys at a time: the K codes (exact in bf16) are widened from shared
//     memory into B fragments (`widen` for int8, `nib2` for int4).  The sum
//     runs over hd in a permuted order (lane t4 of a quad reads the
//     contiguous columns [hd/4 t4, hd/4 (t4 + 1)) of a key row, and Q's
//     fragments are loaded in the same order), so a lane reads a key row in
//     16-byte loads.  At int4 those columns are hd/8 bytes, and each 32-bit
//     word of 8 codes c0..c7 feeds two k steps as the pairs (c0, c4) (c1,
//     c5), then (c2, c6) (c3, c7): a pair is the nibble of each 16-bit half
//     that one shift and one mask select, and Q's fragments are permuted to
//     match once, when they are loaded.  The scores become (q . k8) * (ks *
//     scale) in that order of the multiplies, -1e30 where masked and -inf
//     past S (the JAX kernel has no keys past S).  The online softmax keeps
//     (m, l) per row; alpha = exp(min(m_prev - m_new, 0)), m starts at
//     -1e30.  p * vs is rounded to bf16 and becomes the A fragment of O +=
//     P V directly (FlashAttention-2's register layout); V's B fragments
//     take one code of each of four key rows, so the PV product's columns
//     are permuted too (lane g of n8 tile n holds output column hd/8 g + n)
//     and a lane reads hd/8 contiguous codes of each of its key rows (hd/16
//     bytes at int4: one byte permute puts the same nibble of two rows into
//     the halves of a word, and `nib2` widens that pair).  The 128-byte
//     swizzle makes both the K and the V reads conflict-free at int8 hd 128.
//   - The key splits of a row tile merge their (m, l, O) through shared
//     memory in split order.  With one chunk the unit writes out = O * (1 /
//     l) in bf16; with more, each unit writes (m, l, O) in f32 to a
//     workspace and `kv8_merge_kernel`, launched under programmatic
//     dependent launch, merges the chunks in chunk order: the output has
//     the same bits on every run.
// The rounding point: the TPU rounds bf16(p_norm * vs), p normalised by the
// row's final sum; this kernel rounds bf16(exp(s - m_running) * vs) and
// divides by l at the end, in one pass over the cache.  Both lie within the
// 6e-3 band that tests/test_kv8.py sets for this bf16 P.
// What holds it (PERF.md, kv8_variants.py): the warps' products and
// softmax, not the stream: the ring alone takes under half its time.  The
// int4 instance streams half the bytes and does the same products, so it
// takes about the int8 kernel's time (0.84x at the B = 4 shape, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// The plan's constants, mirrored by ops/kv8_attention.py (KV8_*; a CPU test
// reads them here).
constexpr int kKeys = 128;           // keys per ring stage
constexpr int kGroup = 32;           // keys a warp takes at a time
constexpr int kMaxStages = 6;        // the plan takes 2 (KV8_STAGES)
constexpr int kMaxWarps = 8;         // warps per CTA (half at hd 256)
constexpr int kScaleBytes = 2048;    // a stage's ks [128], vs [128] and mask bytes
constexpr int kMaxG = 16;            // query heads per KV head (the JAX assert)
constexpr int kSmemLimit = 232448;
constexpr float kMasked = -1e30f;    // kv8_attention.py's NEG_INF

// The layout of a head dim HD over a cache of BITS-bit codes (8, or 4
// packed two a byte).
template <int HD, int BITS>
struct Geo {
  static constexpr int kRow = HD * BITS / 8;         // bytes of a K or V row
  static constexpr bool kTma = kRow % 16 == 0;       // else 8-byte cp.async rows
  static constexpr int kBox = kRow < 128 ? kRow : 128;  // bytes of a box row
  static constexpr int kBoxes = kRow / kBox;
  static constexpr int kSwz = kBox == 128 ? 7 : kBox == 64 ? 3 : kBox == 32 ? 1 : 0;
  static constexpr int kTile = kKeys * kRow;         // a stage's K (or V) bytes
  static constexpr int kStage = 2 * kTile + kScaleBytes;
  static constexpr int kDL = HD / 4;   // columns of a K row (and of Q) a lane takes
  static constexpr int kKB = kDL * BITS / 8;   // their bytes
  static constexpr int kNT = HD / 8;   // n8 tiles of O; columns of a V row a lane takes
  static constexpr int kVB = kNT * BITS / 8;   // their bytes
  static constexpr int kKS = HD / 16;  // k16 steps of Q K^T
};

__host__ __device__ constexpr int stage_bytes(int hd, int bits) {
  return 2 * kKeys * (hd * bits / 8) + kScaleBytes;
}

// Dynamic shared memory of a plan: the ring, or the key splits' merge area
// if larger (it reuses the ring), and 1024 bytes of alignment slack.
__host__ __device__ constexpr int kv8_smem(int hd, int bits, int stages, int row_tiles,
                                           int splits) {
  const int ring = stages * stage_bytes(hd, bits);
  const int merge = (splits - 1) * row_tiles * (64 * hd + 512);
  return 1024 + (ring > merge ? ring : merge);
}

// Byte c of key row r of a stage's K or V tile: boxes of kBox bytes a row,
// each in the TMA swizzle of that width (16-byte chunks XOR the row's bits).
template <class L>
__device__ __forceinline__ int tile_off(int r, int c) {
  const int off = (c / L::kBox) * (kKeys * L::kBox) + r * L::kBox + (c % L::kBox);
  return off ^ (((off >> 7) & L::kSwz) << 4);
}

// N bytes (1, 2, 4, 8 or a multiple of 16) of key row r from byte c, as
// words (zero-extended).
template <class L, int N>
__device__ __forceinline__ void load_row(uint32_t (&w)[(N + 3) / 4], const unsigned char* tile,
                                         int r, int c) {
  if constexpr (N == 1) {
    w[0] = tile[tile_off<L>(r, c)];
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(tile + tile_off<L>(r, c));
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(tile + tile_off<L>(r, c));
  } else if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(tile + tile_off<L>(r, c));
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + tile_off<L>(r, c + 16 * i));
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
}

// The widening of int8 codes to bf16.  Codes are read in excess-128 form
// (`excess`: code ^ 0x80 per byte); byte ux of x and byte uy of y are
// placed in the mantissa of 2^23 (f32 0x4B0000xx), shifted back by 2^23 +
// 128 (exact), and the exact f32 values cut to their upper halves: bf16x2
// {x_ux, y_uy}.
__device__ __forceinline__ uint32_t excess(uint32_t w) { return w ^ 0x80808080u; }

__device__ __forceinline__ uint32_t widen(uint32_t x, int ux, uint32_t y, int uy) {
  const float fx = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | ux)) - 8388736.f;
  const float fy = __uint_as_float(__byte_perm(y, 0x4B000000u, 0x7650 | uy)) - 8388736.f;
  return __byte_perm(__float_as_uint(fx), __float_as_uint(fy), 0x7632);
}

// The widening of int4 codes to bf16: nibble s of each 16-bit half of w,
// as bf16x2 {low half's, high half's}.  A code n in [-8, 7] is n ^ 8 = n + 8
// in excess-8; bf16 0x4300 | (n + 8) is 128 + n + 8 (the nibble fills the
// low mantissa bits of 128), and x * 1 - 136 (exact) is n.
__device__ __forceinline__ uint32_t nib2(uint32_t w, int s) {
  const uint32_t x = ((w >> (4 * s)) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// The copies of the unit's keys [key0, key0 + nk) into ring slot `st`, by
// one whole warp, 33 arrivals on `bar`: lane 0 the TMA loads of K and V
// ([kKeys, row] boxes of up to 128 bytes a row) and their byte count, or,
// for 8-byte rows, a plain arrival while every lane copies rows of K and V
// by 8-byte cp.async (kc, vc the cache at the unit's (batch row, KV head));
// every lane 4-byte cp.asyncs of ks, vs and the mask (as the aligned words
// that hold its bytes, from `address & 3`) and an arrival when they land.
template <class L>
__device__ __forceinline__ void load_tile(unsigned char* st, uint64_t* bar, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, const unsigned char* kc,
                                          const unsigned char* vc, const float* ksr,
                                          const float* vsr, const uint8_t* vrow, int key0,
                                          int nk, int kvh, int lane) {
  if constexpr (L::kTma) {
    if (lane == 0) {
      hopper::mbar_expect_tx(bar, 2 * L::kTile);
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx) {
        hopper::tma_load_3d(st + bx * kKeys * L::kBox, tm_k, bar, bx * L::kBox, key0, kvh);
        hopper::tma_load_3d(st + L::kTile + bx * kKeys * L::kBox, tm_v, bar, bx * L::kBox, key0,
                            kvh);
      }
    }
  } else {
    static_assert(L::kRow == 8, "cp.async rows are 8 bytes");
    if (lane == 0) hopper::mbar_arrive(bar);
    for (int e = lane; e < nk; e += 32) {
      cp_async8(st + 8 * e, kc + 8 * (static_cast<long>(key0) + e));
      cp_async8(st + L::kTile + 8 * e, vc + 8 * (static_cast<long>(key0) + e));
    }
  }
  float* sks = reinterpret_cast<float*>(st + 2 * L::kTile);
  for (int e = lane; e < nk; e += 32) {
    cp_async4(sks + e, ksr + key0 + e);
    cp_async4(sks + kKeys + e, vsr + key0 + e);
  }
  if (vrow != nullptr) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(vrow + key0);
    for (int w = lane; 4 * w < static_cast<int>(a & 3) + nk; w += 32)
      cp_async4(st + 2 * L::kTile + 8 * kKeys + 4 * w,
                reinterpret_cast<const void*>((a & ~static_cast<uintptr_t>(3)) + 4 * w));
  }
  cp_async_arrive(bar);
}

// Threads of a CTA at most (the plan's warps: half at hd 256).
template <int HD>
constexpr int max_threads() { return 32 * (HD <= 128 ? kMaxWarps : kMaxWarps / 2); }

template <int HD, int BITS>
__global__ void __launch_bounds__(max_threads<HD>(), 1)
kv8_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
           const unsigned char* __restrict__ kc, const unsigned char* __restrict__ vc,
           const __nv_bfloat16* __restrict__ q, const float* __restrict__ ks,
           const float* __restrict__ vs, const uint8_t* __restrict__ valid,
           __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int T, int H, int Hkv, int S,
           float scale, int row_tiles, int row_blocks, int splits, int chunks, int stages) {
  using L = Geo<HD, BITS>;
  constexpr int kNT = L::kNT, kDL = L::kDL, kKS = L::kKS;
  constexpr int kChunk = L::kKB < 16 ? L::kKB : 16;    // K bytes a lane loads at once
  constexpr int kVChunk = L::kVB < 16 ? L::kVB : 16;   // V bytes a lane loads at once
  constexpr int kVW = (kVChunk + 3) / 4;               // their words
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int done[kMaxStages];   // warps through each slot, all its tiles
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  hopper::griddep_launch_dependents();   // the chunk merge may be scheduled
  const int nw = row_tiles * splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int u = blockIdx.x;
  const int chunk = u % chunks;
  u /= chunks;
  const int rb = u % row_blocks;
  const int kvh = u / row_blocks;            // b * Hkv + j
  const int b = kvh / Hkv, j = kvh % Hkv;
  const int G = H / Hkv, R = G * T;
  const int tiles = (S + kKeys - 1) / kKeys;
  const int per = (tiles + chunks - 1) / chunks;
  const int t0 = chunk * per, n = min(per, tiles - t0);
  const float* ksr = ks + static_cast<long>(kvh) * S;
  const float* vsr = vs + static_cast<long>(kvh) * S;
  const uint8_t* vrow = valid == nullptr ? nullptr : valid + static_cast<long>(b) * S;
  const long row0 = static_cast<long>(kvh) * S * L::kRow;   // this head's cache bytes
  const unsigned char* kch = kc == nullptr ? nullptr : kc + row0;
  const unsigned char* vch = vc == nullptr ? nullptr : vc + row0;
  auto refill = [&](int i) {   // tile i of the unit into its slot, by this warp
    const int key0 = (t0 + i) * kKeys;
    load_tile<L>(ring + (i % stages) * L::kStage, &full[i % stages], &tm_k, &tm_v, kch, vch, ksr,
                 vsr, vrow, key0, min(kKeys, S - key0), kvh, lane);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 33);   // 32 lanes' cp.async + lane 0's expect_tx or arrival
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < min(stages, n); ++i) refill(i);

  // warp: row tile wr, key groups ksi, ksi + splits, ... of a stage;
  // this lane holds rows r0 and r0 + 8 (of the unit's G*T), columns 2 t4 (+1)
  const int wr = warp % row_tiles, ksi = warp / row_tiles;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (rb * row_tiles + wr) * 16 + g;

  // Q fragments of columns [hd/4 t4, hd/4 (t4 + 1)).  int8: k step ks holds
  // columns hd/4 t4 + 4 ks + {0, 1} (a0 a1 / a2 a3) and + {2, 3} (a4 a5 /
  // a6 a7), the order the K fragments read.  int4: each 8 columns c0..c7
  // make k steps (c0, c4) / (c1, c5) and (c2, c6) / (c3, c7); at hd 16 the
  // 4 columns make one, (c0, c2) / (c1, c3)
  uint32_t qa[kKS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    uint32_t w[kDL / 2];
#pragma unroll
    for (int i = 0; i < kDL / 2; ++i) w[i] = 0;
    if (r < R) {
      const __nv_bfloat16* src =
          q + ((static_cast<long>(b) * T + r % T) * H + j * G + r / T) * HD + kDL * t4;
      if constexpr (kDL / 2 == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[0] = v.x;
        w[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < kDL / 8; ++i) {
          const uint4 v = reinterpret_cast<const uint4*>(src)[i];
          w[4 * i] = v.x;
          w[4 * i + 1] = v.y;
          w[4 * i + 2] = v.z;
          w[4 * i + 3] = v.w;
        }
      }
    }
    if constexpr (BITS == 8) {
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        qa[s][h] = w[2 * s];
        qa[s][2 + h] = w[2 * s + 1];
      }
    } else if constexpr (HD == 16) {
      qa[0][h] = __byte_perm(w[0], w[1], 0x5410);
      qa[0][2 + h] = __byte_perm(w[0], w[1], 0x7632);
    } else {
#pragma unroll
      for (int m = 0; m < kKS / 2; ++m) {
        qa[2 * m][h] = __byte_perm(w[4 * m], w[4 * m + 2], 0x5410);
        qa[2 * m][2 + h] = __byte_perm(w[4 * m], w[4 * m + 2], 0x7632);
        qa[2 * m + 1][h] = __byte_perm(w[4 * m + 1], w[4 * m + 3], 0x5410);
        qa[2 * m + 1][2 + h] = __byte_perm(w[4 * m + 1], w[4 * m + 3], 0x7632);
      }
    }
  }

  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  int stage = 0, phase = 0;
  for (int i = 0; i < n; ++i) {
    const int key0 = (t0 + i) * kKeys;
    hopper::mbar_wait(&full[stage], phase);
    const unsigned char* kt = ring + stage * L::kStage;
    const unsigned char* vt = kt + L::kTile;
    const float* sks = reinterpret_cast<const float*>(kt + 2 * L::kTile);
    const float* svs = sks + kKeys;
    const uint8_t* sval =
        vrow == nullptr
            ? nullptr
            : kt + 2 * L::kTile + 8 * kKeys + (reinterpret_cast<uintptr_t>(vrow + key0) & 3);
    for (int kg = ksi; kg < kKeys / kGroup && key0 + kg * kGroup < S; kg += splits) {
      // S = Q K^T over the group's 32 keys: four n8 tiles; lane g of tile jt
      // reads key kg * 32 + 8 jt + g, up to 16 bytes (4 k steps of int8, 8
      // of int4) at a time
      float sc[4][4];
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) sc[jt][0] = sc[jt][1] = sc[jt][2] = sc[jt][3] = 0.f;
#pragma unroll
      for (int c0 = 0; c0 < L::kKB; c0 += kChunk) {
        uint32_t kw[4][(kChunk + 3) / 4];
#pragma unroll
        for (int jt = 0; jt < 4; ++jt)
          load_row<L, kChunk>(kw[jt], kt, kg * kGroup + jt * 8 + g, L::kKB * t4 + c0);
        if constexpr (BITS == 8) {
#pragma unroll
          for (int s = 0; s < kChunk / 4; ++s)
#pragma unroll
            for (int jt = 0; jt < 4; ++jt) {
              const uint32_t w = excess(kw[jt][s]);
              mma_bf16(sc[jt], qa[c0 / 4 + s], widen(w, 0, w, 1), widen(w, 2, w, 3));
            }
        } else if constexpr (kChunk == 2) {   // int4 hd 16: one k step
#pragma unroll
          for (int jt = 0; jt < 4; ++jt) {
            const uint32_t w = __byte_perm(kw[jt][0], 0, 0x3120);   // bytes to the halves
            mma_bf16(sc[jt], qa[0], nib2(w, 0), nib2(w, 1));
          }
        } else {
#pragma unroll
          for (int s = 0; s < kChunk / 4; ++s)
#pragma unroll
            for (int jt = 0; jt < 4; ++jt) {
              const uint32_t w = kw[jt][s];
              const int k = 2 * (c0 / 4 + s);
              mma_bf16(sc[jt], qa[k], nib2(w, 0), nib2(w, 1));
              mma_bf16(sc[jt], qa[k + 1], nib2(w, 2), nib2(w, 3));
            }
        }
      }
      // (q . k8) * (ks * scale); -1e30 where masked, -inf past S
#pragma unroll
      for (int jt = 0; jt < 4; ++jt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kg * kGroup + jt * 8 + 2 * t4 + e;
          if (key0 + key < S) {
            const float kcol = __fmul_rn(sks[key], scale);
            const bool ok = sval == nullptr || sval[key] != 0;
            sc[jt][e] = ok ? __fmul_rn(sc[jt][e], kcol) : kMasked;
            sc[jt][2 + e] = ok ? __fmul_rn(sc[jt][2 + e], kcol) : kMasked;
          } else {
            sc[jt][e] = sc[jt][2 + e] = -INFINITY;
          }
        }
      // the online softmax of rows r0 (m0, l0) and r0 + 8 (m1, l1)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        mx0 = fmaxf(mx0, fmaxf(sc[jt][0], sc[jt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[jt][2], sc[jt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = expf(fminf(m0 - mx0, 0.f)), a1 = expf(fminf(m1 - mx1, 0.f));
      m0 = mx0;
      m1 = mx1;
      if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
        for (int d = 0; d < kNT; ++d) {
          acc[d][0] *= a0;
          acc[d][1] *= a0;
          acc[d][2] *= a1;
          acc[d][3] *= a1;
        }
      }
      l0 *= a0;
      l1 *= a1;
      uint32_t pa[2][4];   // bf16(p * vs): the A fragments of the PV product
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kg * kGroup + jt * 8 + 2 * t4 + e;
          const float p0 = expf(sc[jt][e] - m0), p1 = expf(sc[jt][2 + e] - m1);
          l0 += p0;
          l1 += p1;
          const float v = key0 + key < S ? svs[key] : 0.f;
          pv[e] = __fmul_rn(p0, v);
          pv[2 + e] = __fmul_rn(p1, v);
        }
        pa[jt >> 1][2 * (jt & 1)] = pack_bf16(pv[0], pv[1]);
        pa[jt >> 1][2 * (jt & 1) + 1] = pack_bf16(pv[2], pv[3]);
      }
      // O += P V, a k16 step at a time: keys 2 t4 (+1) and 2 t4 + 8 (+1) of
      // the step; lane g of n8 tile d holds output column kNT g + d
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int vr = kg * kGroup + 16 * u + 2 * t4;
#pragma unroll
        for (int c0 = 0; c0 < L::kVB; c0 += kVChunk) {
          uint32_t va[kVW], vb[kVW], vc4[kVW], vd[kVW];
          load_row<L, kVChunk>(va, vt, vr, L::kVB * g + c0);
          load_row<L, kVChunk>(vb, vt, vr + 1, L::kVB * g + c0);
          load_row<L, kVChunk>(vc4, vt, vr + 8, L::kVB * g + c0);
          load_row<L, kVChunk>(vd, vt, vr + 9, L::kVB * g + c0);
          if constexpr (BITS == 8) {
#pragma unroll
            for (int w = 0; w < kVW; ++w) {
              va[w] = excess(va[w]);
              vb[w] = excess(vb[w]);
              vc4[w] = excess(vc4[w]);
              vd[w] = excess(vd[w]);
            }
#pragma unroll
            for (int d = 0; d < kVChunk; ++d) {
              const int w = d >> 2, x = d & 3;
              mma_bf16(acc[c0 + d], pa[u], widen(va[w], x, vb[w], x), widen(vc4[w], x, vd[w], x));
            }
          } else {
            // column d of the chunk: nibble d & 7 of word d >> 3, the same
            // nibble of rows vr / vr + 1 (and vr + 8 / vr + 9) into the
            // halves of one word
#pragma unroll
            for (int d = 0; d < 2 * kVChunk; ++d) {
              const int w = d >> 3, x = d & 7;
              const uint32_t sel = x < 4 ? 0x5410 : 0x7632;
              mma_bf16(acc[2 * c0 + d], pa[u], nib2(__byte_perm(va[w], vb[w], sel), x & 3),
                       nib2(__byte_perm(vc4[w], vd[w], sel), x & 3));
            }
          }
        }
      }
    }
    // the last warp through the slot (the count of its round's warps)
    // refills it with the tile `stages` on, after the other warps' reads
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[stage], 1) == (i / stages + 1) * nw - 1;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && i + stages < n) {
      __threadfence_block();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      refill(i + stages);
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // the key splits of a row tile merge in split order, through the ring
  // (every stage has been read once all warps pass the first barrier)
  if (splits > 1) {
    constexpr int kSlot = (4 * kNT + 4) * 32;   // floats, lane-minor
    float* area = reinterpret_cast<float*>(ring);
    __syncthreads();
    if (ksi > 0) {
      float* slot = area + ((ksi - 1) * row_tiles + wr) * kSlot + lane;
#pragma unroll
      for (int d = 0; d < kNT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) slot[(4 * d + e) * 32] = acc[d][e];
      slot[(4 * kNT) * 32] = m0;
      slot[(4 * kNT + 1) * 32] = m1;
      slot[(4 * kNT + 2) * 32] = l0;
      slot[(4 * kNT + 3) * 32] = l1;
    }
    __syncthreads();
    if (ksi > 0) return;
    float M0 = m0, M1 = m1;
    for (int k = 1; k < splits; ++k) {
      const float* slot = area + ((k - 1) * row_tiles + wr) * kSlot + lane;
      M0 = fmaxf(M0, slot[(4 * kNT) * 32]);
      M1 = fmaxf(M1, slot[(4 * kNT + 1) * 32]);
    }
    float e0 = expf(m0 - M0), e1 = expf(m1 - M1);
    l0 *= e0;
    l1 *= e1;
#pragma unroll
    for (int d = 0; d < kNT; ++d) {
      acc[d][0] *= e0;
      acc[d][1] *= e0;
      acc[d][2] *= e1;
      acc[d][3] *= e1;
    }
    for (int k = 1; k < splits; ++k) {
      const float* slot = area + ((k - 1) * row_tiles + wr) * kSlot + lane;
      e0 = expf(slot[(4 * kNT) * 32] - M0);
      e1 = expf(slot[(4 * kNT + 1) * 32] - M1);
      l0 += slot[(4 * kNT + 2) * 32] * e0;
      l1 += slot[(4 * kNT + 3) * 32] * e1;
#pragma unroll
      for (int d = 0; d < kNT; ++d) {
        acc[d][0] += slot[(4 * d) * 32] * e0;
        acc[d][1] += slot[(4 * d + 1) * 32] * e0;
        acc[d][2] += slot[(4 * d + 2) * 32] * e1;
        acc[d][3] += slot[(4 * d + 3) * 32] * e1;
      }
    }
    m0 = M0;
    m1 = M1;
  }

  // this lane's columns of a row: [hd/4 t4, hd/4 (t4 + 1)), from n8 tile d's
  // column 2 t4 (c < kNT) or 2 t4 + 1 (c >= kNT)
  const int rows_cta = row_tiles * 16;
  const long unit = blockIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= R) continue;
    const float l = h ? l1 : l0;
    if (chunks == 1) {
      const float inv = 1.f / l;   // one quotient a row, as the flash kernels
      uint32_t o[kNT];
#pragma unroll
      for (int c = 0; c < kNT / 2; ++c) {
        o[c] = pack_bf16(acc[2 * c][2 * h] * inv, acc[2 * c + 1][2 * h] * inv);
        o[kNT / 2 + c] = pack_bf16(acc[2 * c][2 * h + 1] * inv, acc[2 * c + 1][2 * h + 1] * inv);
      }
      __nv_bfloat16* dst =
          out + ((static_cast<long>(b) * T + r % T) * H + j * G + r / T) * HD + 2 * kNT * t4;
      if constexpr (kNT == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
      } else {
#pragma unroll
        for (int c = 0; c < kNT / 4; ++c)
          reinterpret_cast<uint4*>(dst)[c] = make_uint4(o[4 * c], o[4 * c + 1], o[4 * c + 2],
                                                        o[4 * c + 3]);
      }
    } else {
      const int rl = r - rb * rows_cta;
      float* dst = ws + (unit * rows_cta + rl) * HD + 2 * kNT * t4;
#pragma unroll
      for (int c = 0; c < kNT; c += 2) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(acc[c][2 * h], acc[c + 1][2 * h]);
        *reinterpret_cast<float2*>(dst + kNT + c) =
            make_float2(acc[c][2 * h + 1], acc[c + 1][2 * h + 1]);
      }
      if (t4 == 0) {
        float* ml = ws + static_cast<long>(gridDim.x) * rows_cta * HD + (unit * rows_cta + rl) * 2;
        ml[0] = h ? m1 : m0;
        ml[1] = l;
      }
    }
  }
}

// Merges the chunks of each (batch row, KV head, row block) in chunk order:
// m = max m_c, l = sum l_c exp(m_c - m), out = sum O_c exp(m_c - m) / l.
// One thread per 4 output columns of a row; block x is the (batch row, KV
// head, row block), block y a slice of its rows.
__global__ void __launch_bounds__(128)
kv8_merge_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int T, int H,
                 int Hkv, int hd, int rows_cta, int row_blocks, int chunks, long ml_off) {
  hopper::griddep_wait();   // the partials of the kernel before
  const int rb = blockIdx.x % row_blocks, kvh = blockIdx.x / row_blocks;
  const int b = kvh / Hkv, j = kvh % Hkv, G = H / Hkv;
  const int quads = hd / 4;
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  const int rl = idx / quads, d = (idx % quads) * 4;
  const int r = rb * rows_cta + rl;
  if (rl >= rows_cta || r >= G * T) return;
  const long base = static_cast<long>(blockIdx.x) * chunks * rows_cta + rl;   // chunk 0's row
  const float* ml = ws + ml_off;
  float m = kMasked;
  for (int c = 0; c < chunks; ++c) m = fmaxf(m, ml[(base + static_cast<long>(c) * rows_cta) * 2]);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < chunks; ++c) {
    const long row = base + static_cast<long>(c) * rows_cta;
    const float e = expf(ml[row * 2] - m);
    l += ml[row * 2 + 1] * e;
    const float4 x = *reinterpret_cast<const float4*>(ws + row * hd + d);
    o.x += x.x * e;
    o.y += x.y * e;
    o.z += x.z * e;
    o.w += x.w * e;
  }
  __nv_bfloat16* dst = out + ((static_cast<long>(b) * T + r % T) * H + j * G + r / T) * hd + d;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(o.x * (1.f / l), o.y * (1.f / l)),
                 pack_bf16(o.z * (1.f / l), o.w * (1.f / l)));
}

template <int HD, int BITS>
int launch(const CUtensorMap* maps, const void* kc, const void* vc, const void* q, const void* ks,
           const void* vs, const void* valid, void* out, void* ws, int units, int T, int H,
           int Hkv, int S, float scale, int row_tiles, int row_blocks, int splits, int chunks,
           int stages, int smem, cudaStream_t st) {
  static int allowed = 0;
  const int err = hopper::allow_smem(kv8_kernel<HD, BITS>, smem, allowed);
  if (err) return err;
  kv8_kernel<HD, BITS><<<units, 32 * row_tiles * splits, smem, st>>>(
      maps[0], maps[1], Geo<HD, BITS>::kTma ? nullptr : static_cast<const unsigned char*>(kc),
      Geo<HD, BITS>::kTma ? nullptr : static_cast<const unsigned char*>(vc),
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), T, H, Hkv, S, scale, row_tiles,
      row_blocks, splits, chunks, stages);
  return static_cast<int>(cudaGetLastError());
}

// The C entry of both widths (see below); BITS 8 or 4.
template <int BITS>
int decode_attention(const void* q, const void* k8, const void* ks, const void* v8,
                     const void* vs, const void* valid, void* out, void* ws, int B, int T, int H,
                     int Hkv, int S, int hd, float scale, int row_tiles, int row_blocks,
                     int splits, int chunks, int stages, int smem, void* stream) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > kMaxG ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256))
    return kBad;
  const int rows = (H / Hkv) * T, tiles = (S + kKeys - 1) / kKeys;
  const int max_warps = hd <= 128 ? kMaxWarps : kMaxWarps / 2;
  if ((splits != 1 && splits != 2 && splits != 4) || row_tiles < 1 ||
      row_tiles * splits > max_warps || row_blocks < 1 || row_blocks * row_tiles * 16 < rows ||
      (row_blocks - 1) * row_tiles * 16 >= rows || chunks < 1 || chunks > tiles ||
      (chunks - 1) * ((tiles + chunks - 1) / chunks) >= tiles || stages < 2 ||
      stages > kMaxStages || smem != kv8_smem(hd, BITS, stages, row_tiles, splits) ||
      smem > kSmemLimit || (chunks > 1 && ws == nullptr))
    return kBad;
  for (const void* p : {q, k8, v8, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kBad;
  for (const void* p : {ks, vs})
    if (reinterpret_cast<uintptr_t>(p) % 4) return kBad;
  // K and V as [B * Hkv][S][row] bytes: boxes of kKeys keys x 128 bytes (an
  // int8 row of hd 256: two), or of the whole row below 128, in the swizzle
  // of the box width; rows of 8 bytes (int4 hd 16) load by cp.async
  const int row = hd * BITS / 8;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (row % 16 == 0) {
    const int box = row < 128 ? row : 128;
    const CUtensorMapSwizzle swizzle = box == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : box == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : box == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                   : CU_TENSOR_MAP_SWIZZLE_NONE;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B) * Hkv};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row),
                                   static_cast<cuuint64_t>(S) * row};
    const cuuint32_t boxd[3] = {static_cast<cuuint32_t>(box), kKeys, 1};
    if (!hopper::encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k8, dims, strides, boxd,
                            swizzle) ||
        !hopper::encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v8, dims, strides, boxd,
                            swizzle))
      return kBad;
  }
  const int units = B * Hkv * row_blocks * chunks;
  const auto st = static_cast<cudaStream_t>(stream);
  int err;
  switch (hd) {
    case 16:
      err = launch<16, BITS>(maps, k8, v8, q, ks, vs, valid, out, ws, units, T, H, Hkv, S, scale,
                             row_tiles, row_blocks, splits, chunks, stages, smem, st);
      break;
    case 32:
      err = launch<32, BITS>(maps, k8, v8, q, ks, vs, valid, out, ws, units, T, H, Hkv, S, scale,
                             row_tiles, row_blocks, splits, chunks, stages, smem, st);
      break;
    case 64:
      err = launch<64, BITS>(maps, k8, v8, q, ks, vs, valid, out, ws, units, T, H, Hkv, S, scale,
                             row_tiles, row_blocks, splits, chunks, stages, smem, st);
      break;
    case 128:
      err = launch<128, BITS>(maps, k8, v8, q, ks, vs, valid, out, ws, units, T, H, Hkv, S, scale,
                              row_tiles, row_blocks, splits, chunks, stages, smem, st);
      break;
    default:
      err = launch<256, BITS>(maps, k8, v8, q, ks, vs, valid, out, ws, units, T, H, Hkv, S, scale,
                              row_tiles, row_blocks, splits, chunks, stages, smem, st);
  }
  if (err || chunks == 1) return err;
  const int rows_cta = row_tiles * 16;
  err = hopper::launch_dependent(kv8_merge_kernel,
                                 dim3(B * Hkv * row_blocks, (rows_cta * hd / 4 + 127) / 128),
                                 dim3(128), 0, st,
                                 static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out),
                                 T, H, Hkv, hd, rows_cta, row_blocks, chunks,
                                 static_cast<long>(units) * rows_cta * hd);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, T, H, hd] bf16; k8, v8 [B, Hkv, S, hd] int8; ks, vs [B, Hkv, 1, S]
// f32; valid [B, S] bool (one byte a key) or null (all keys valid); out [B,
// T, H, hd] bf16; ws the chunks' partials, f32 [units, row_tiles * 16, hd]
// then [units, row_tiles * 16, 2], or null with one chunk.  hd 16, 32, 64,
// 128 or 256; H a multiple of Hkv, at most kMaxG times it.  The plan
// (row_tiles, row_blocks, splits, chunks, stages, smem) is kv8_plan's.
// Returns a cudaError_t.
extern "C" int lavida_kv8_decode_attention(const void* q, const void* k8, const void* ks,
                                           const void* v8, const void* vs, const void* valid,
                                           void* out, void* ws, int B, int T, int H, int Hkv,
                                           int S, int hd, float scale, int row_tiles,
                                           int row_blocks, int splits, int chunks, int stages,
                                           int smem, void* stream) {
  return decode_attention<8>(q, k8, ks, v8, vs, valid, out, ws, B, T, H, Hkv, S, hd, scale,
                             row_tiles, row_blocks, splits, chunks, stages, smem, stream);
}

// The same over the int4 cache: k4, v4 [B, Hkv, S, hd / 2] bytes of two
// codes in [-8, 7] each (code 2i in the low nibble of byte i); the plan is
// kv8_plan's with bits=4.
extern "C" int lavida_kv4_decode_attention(const void* q, const void* k4, const void* ks,
                                           const void* v4, const void* vs, const void* valid,
                                           void* out, void* ws, int B, int T, int H, int Hkv,
                                           int S, int hd, float scale, int row_tiles,
                                           int row_blocks, int splits, int chunks, int stages,
                                           int smem, void* stream) {
  return decode_attention<4>(q, k4, ks, v4, vs, valid, out, ws, B, T, H, Hkv, S, hd, scale,
                             row_tiles, row_blocks, splits, chunks, stages, smem, stream);
}
