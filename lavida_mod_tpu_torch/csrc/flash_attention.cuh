// The flash-attention pipeline for Hopper (sm_90a) shared by
// short_attention.cu (kernel #1, segment-id mask) and prefix_flash.cu
// (kernel #10, prefix-LM mask): the forward kernel body, and the pieces the
// backward kernels of prefix_flash.cu build on (tile layouts in shared
// memory, wgmma descriptors and products, the named-barrier ping-pong, the
// TMA tensor maps of a [B, L, H, hd] tensor).
//
// The forward (`flash_fwd`): one CTA per (128 query rows, q head, batch
// row) runs a producer warpgroup and two consumer warpgroups of 64 query
// rows each.  One producer warp copies the Q tile once and K/V tiles of 128
// keys into a three-stage ring in shared memory with TMA (4-D tensor maps
// over [B, L, H, hd]), together with one int per key of the tile that the
// mask reads (plain loads into shared memory, so the mask is never re-read
// from device memory per element); `mbarrier` pairs order the ring.  A
// tile's head dim is copied as 64-column boxes in 128-byte swizzled rows
// plus, for hd 65-96 and up to 32, one narrow box of the last 16 or 32
// columns in 32- or 64-byte swizzled rows (`Layout`): the maps' head-dim
// extent is hd, so TMA zero-fills the columns past it, which pads hd = 72
// to the 80 of the QK^T depth with 8 columns of fill instead of the 56 a
// second 64-column box would copy, and the rows past T or S.  The producer
// warpgroup gives its registers to the consumers (`setmaxnreg`: 24 and 240
// of the 168 each thread has at launch; 128 x 24 + 256 x 240 is 384 x 168,
// so a build with fewer registers at entry would leave `setmaxnreg.inc`
// waiting: kernels.py refuses such a build).  Each consumer computes S =
// Q K^T with `wgmma.m64n128k16` (Q and K both K-major in shared memory),
// masks and rescales in f32 registers with exp2 (log2 e folded into the
// score scale; the finite -1e30 mask is set after the fold, so a tile with
// no visible key is still cleared by exp2(-1e30 - m) = 0 once a visible max
// arrives), packs the unnormalized p to bf16 in registers and feeds it as
// the A operand of O += P V (`wgmma.m64n{64,128,..}k16` over the 64-column
// boxes and one of width 16 or 32 over the narrow box; V the MN-major B
// operand through the transpose bit).  Inside a warpgroup the products are
// pipelined: S of tile j and P V of tile j - 1 are issued together, and the
// softmax of tile j runs while P V runs; across the two warpgroups two named
// barriers hand the tensor cores back and forth (ping-pong), so one
// warpgroup's softmax overlaps the other's products.  Keys past S get -inf
// (they leave the softmax); query rows past T are not stored; any S works,
// as K/V stream through the ring.
//
// The two masks (`kPrefix`):
//   segment ids (kernel #1): key c is hidden from query t when their
//     segment ids differ; no mask when the ids are null;
//   prefix-LM (kernel #10): the int of key c is 0 when kv_valid[c] and c <
//     plen, 1 when kv_valid[c] and c >= plen, 2 when !kv_valid[c]; the
//     row's level is 1 when t >= plen, else 0; the key is hidden when its
//     int exceeds the level.  The CTA visits only the K/V tiles that hold a
//     key one of its rows can see (`prefix_tiles`: from the first valid key
//     to the last, or to plen when every row lies inside the prefix).  A
//     skipped tile only adds exp2(-1e30 - m) = 0 terms to a row that sees a
//     key, so skipping changes no bit of it; a CTA holding a row that sees
//     no key visits every tile.  The CTA also stores lse = m + log(max(l,
//     1e-30)) in natural log, o = acc / max(l, 1e-30), and rescales with the
//     guard alpha = exp2(min(m_prev - m_new, 0)).
// A row that sees no key (either mask) sums v over the S keys, each at p =
// exp2(0) = 1, and divides by the key count the TPU wrapper pads S to
// (`padded_keys`): its zero pad keys score -1e30 too and add one each to
// the row sum (the TPU's -1e30 behaviour).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

using namespace hopper;

constexpr int kBM = 128;       // query rows per CTA (64 per consumer warpgroup)
constexpr int kBN = 128;       // keys per streamed tile
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory matrix descriptor of rows `row` bytes wide (128, 64 or 32)
// in the swizzle of that width: `lbo` is the byte stride between the
// swizzle-wide column blocks of an MN-major operand (unused for K-major
// ones), 8-row core groups sit 8 rows apart.
template <int row>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  static_assert(row == 128 || row == 64 || row == 32, "a swizzle width");
  constexpr uint64_t layout = row == 128 ? 1 : row == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(8 * row >> 4) << 32) |
         (layout << 62);
}

// The head dim of one Q, K or V tile of ROWS rows in shared memory: kMain
// boxes of 64 columns in 128-byte swizzled rows, then for HDP = 16, 32, 80
// or 96 a tail box of the last 16 or 32 columns in 32- or 64-byte swizzled
// rows.  (For hd = 72 a second 64-column box would be 56 columns of TMA
// zero fill, which costs the copy about as much as real data.)
template <int HDP, int ROWS = 128>
struct Layout {
  static constexpr int kBox = 64 * ROWS * 2;  // one 64-column box
  static constexpr int kTailCols = HDP % 64 == 16 || HDP % 64 == 32 ? HDP % 64 : 0;
  static constexpr int kMain = (HDP - kTailCols) / 64 + ((HDP - kTailCols) % 64 != 0);
  static constexpr int kMainCols = kTailCols ? 64 * kMain : HDP;  // the main product's width
  static constexpr int kTailRow = 2 * kTailCols;                  // bytes of a tail row
  static constexpr int kTile = kMain * kBox + ROWS * kTailRow;    // a multiple of 1024
};

// Fragments of bf16 pairs stay live until the product that reads them is
// done (see hopper::fence_acc).
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barriers 1 and 2 hand the tensor cores from one consumer
// warpgroup to the other (bar.sync by the 128 threads that wait, bar.arrive
// by the 128 of the other warpgroup).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) = A (64 x 16, K-major smem) * B (16 x 64, K-major smem),
// D's earlier values neither read nor kept live (the first k16 step of a
// product whose accumulator holds nothing of value before it)
__device__ __forceinline__ void wgmma_ss_fresh64(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// D (64 x N, f32) (+)= A (64 x 16 bf16, A fragments in registers) * B (16
// x N, MN-major smem: the transpose bit), one specialization per N.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// C = A B^T over the head dim: A's 64 rows (K-major, `a` in the 64-column
// boxes `box_a` bytes apart, `a_tail` in the tail box) times B's N rows
// (likewise), in k16 steps of 32 bytes along a swizzled row.  kFresh (N =
// 64): C's earlier values are dead, and the first step does not read them.
template <int HDP, int N, bool kFresh = false>
__device__ __forceinline__ void qk_product(float (&c)[N / 2], const unsigned char* a,
                                           const unsigned char* a_tail, int box_a,
                                           const unsigned char* b, const unsigned char* b_tail,
                                           int box_b) {
  using L = Layout<HDP>;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint64_t da = 0, db = 0;
    if (kk < 4 * L::kMain) {
      const int kb = kk / 4, off = (kk % 4) * 32;
      da = smem_desc<128>(a + kb * box_a + off, 16);
      db = smem_desc<128>(b + kb * box_b + off, 16);
    } else if constexpr (L::kTailCols > 0) {
      const int off = (kk - 4 * L::kMain) * 32;
      da = smem_desc<L::kTailRow>(a_tail + off, 16);
      db = smem_desc<L::kTailRow>(b_tail + off, 16);
    }
    if constexpr (kFresh) {
      static_assert(N == 64, "the fresh first step is m64n64");
      if (kk == 0) {
        wgmma_ss_fresh64(c, da, db);
        continue;
      }
    }
    wgmma_ss<N>(c, da, db, kk > 0);
  }
}

// O (64 x HDP) += P (64 x 16 KS, bf16 A fragments) V (16 KS rows of a tile
// of ROWS rows, MN-major: the head dim contiguous) from row `row0` of the
// tile; the 64-column boxes one box apart, the tail in a product of its own.
template <int HDP, int ROWS, int KS>
__device__ __forceinline__ void pv_product(float (&o)[HDP / 2], const uint32_t (&pf)[KS][4],
                                           const unsigned char* v, int row0) {
  using L = Layout<HDP, ROWS>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int r = row0 + kk * 16;
    if constexpr (L::kMainCols > 0) {
      wgmma_rs<L::kMainCols>(*reinterpret_cast<float(*)[L::kMainCols / 2]>(o), pf[kk],
                             smem_desc<128>(v + r * 128, L::kBox), 1);
    }
    if constexpr (L::kTailCols > 0) {
      wgmma_rs<L::kTailCols>(*reinterpret_cast<float(*)[L::kTailCols / 2]>(o + L::kMainCols / 2),
                             pf[kk],
                             smem_desc<L::kTailRow>(v + L::kMain * L::kBox + r * L::kTailRow,
                                                    ROWS * L::kTailRow),
                             1);
    }
  }
}

// The online-softmax state of this thread's two query rows (log2 domain).
struct Rows {
  int qs0, qs1;                          // their segment ids / prefix levels
  float m0 = -INFINITY, m1 = -INFINITY;  // running max
  float l0 = 0.f, l1 = 0.f;              // running sum of the unrounded p
};

// Is a key with mask int `kc` hidden from a row with `q`?
template <bool kPrefix>
__device__ __forceinline__ bool hidden(int kc, int q) {
  return kPrefix ? kc > q : kc != q;
}

// One tile's scores (this thread's 2 x 32 of the 64 x 128 f32 tile) ->
// p = exp2(s * scale_log2 - m) in place.  Keys at or past `valid` get -inf
// (they leave the softmax); a hidden key gets the finite kMaskValue after
// the scale, so exp2(kMaskValue - m) is 0 once a visible key sets m, and a
// row that sees no key averages over all of them.  Updates m and l (from
// the unrounded f32 p, as the TPU kernel sums it) and returns the factors
// that rescale the earlier o.
template <bool kPrefix>
__device__ __forceinline__ void softmax_tile(float (&s)[64], const int32_t* seg, bool masked,
                                             int valid, int t4, float scale_log2, Rows& r,
                                             float& alpha0, float& alpha1) {
  if (masked || valid < kBN) {  // uniform over the CTA
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const int c = jj * 8 + 2 * t4;
      int2 ks = make_int2(r.qs0, r.qs0);
      if (masked) ks = *reinterpret_cast<const int2*>(seg + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = s[4 * jj + e] * scale_log2, bb = s[4 * jj + 2 + e] * scale_log2;
        if (c + e >= valid) {
          a = -INFINITY;
          bb = -INFINITY;
        } else if (masked) {
          const int kseg = e ? ks.y : ks.x;
          if (hidden<kPrefix>(kseg, r.qs0)) a = kMaskValue;
          if (hidden<kPrefix>(kseg, r.qs1)) bb = kMaskValue;
        }
        s[4 * jj + e] = a;
        s[4 * jj + 2 + e] = bb;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < kBN / 8; ++jj) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // key 0 of every tile is below `valid`, so the new max is finite
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  if (kPrefix) {  // the TPU kernel's guard
    alpha0 = ex2(fminf(r.m0 - mn0, 0.f));
    alpha1 = ex2(fminf(r.m1 - mn1, 0.f));
  } else {
    alpha0 = ex2(r.m0 - mn0);
    alpha1 = ex2(r.m1 - mn1);
  }
  r.m0 = mn0;
  r.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < kBN / 8; ++jj) {
    s[4 * jj + 0] = ex2(s[4 * jj + 0] - mn0);
    s[4 * jj + 1] = ex2(s[4 * jj + 1] - mn0);
    s[4 * jj + 2] = ex2(s[4 * jj + 2] - mn1);
    s[4 * jj + 3] = ex2(s[4 * jj + 3] - mn1);
    sum0 += s[4 * jj] + s[4 * jj + 1];
    sum1 += s[4 * jj + 2] + s[4 * jj + 3];
  }
  r.l0 = r.l0 * alpha0 + sum0;
  r.l1 = r.l1 * alpha1 + sum1;
}

// An f32 tile of N columns (accumulator layout) -> bf16 pairs in the
// A-fragment layout of a product over those columns: k16 step kk holds
// columns 16 kk .. 16 kk + 15
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N / 2], uint32_t (&pf)[N / 16][4]) {
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    pf[jj >> 1][(jj & 1) * 2 + 0] = pack_bf16x2(s[4 * jj + 0], s[4 * jj + 1]);
    pf[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16x2(s[4 * jj + 2], s[4 * jj + 3]);
  }
}

// The keys [x, y) from the first to the last valid one of a row of S ints
// (x = S, y = 0 when none is); every thread of the CTA calls it and gets
// the answer.  `sh` holds {S, 0} from before a __syncthreads.
__device__ __forceinline__ int2 valid_key_range(const int32_t* valid, int S, int* sh) {
  int lo = S, hi = 0;
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    if (valid[c]) {
      lo = min(lo, c);
      hi = c + 1;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&sh[0], lo);
    atomicMax(&sh[1], hi);
  }
  __syncthreads();
  return make_int2(sh[0], sh[1]);
}

// The prefix-LM mask int of key `kv` (see the header comment).
__device__ __forceinline__ int32_t prefix_code(const int32_t* valid, int kv, int S, int plen) {
  return kv < S && valid[kv] ? (kv < plen ? 0 : 1) : 2;
}

// The K/V tiles [j_lo, j_hi) that hold a key one of the query rows [q0,
// q_end) can see, given the valid keys [keys.x, keys.y) and plen; empty
// when no row sees a key.
__device__ __forceinline__ int2 prefix_tiles(int2 keys, int plen, int q0, int q_end) {
  const bool pre = q0 < plen, post = q_end > plen;  // a row inside / after the prefix
  const bool any = keys.y > 0, below = any && keys.x < plen;
  int hi = 0;
  if (post && any) {
    hi = keys.y;
  } else if (pre && below) {
    hi = min(plen, keys.y);
  } else {
    return make_int2(0, 0);
  }
  return make_int2(keys.x / kBN, (hi + kBN - 1) / kBN);
}

// 128-byte swizzled tiles sit on 1024-byte boundaries
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// TMA copies of one tile of Layout<HDP, ROWS> (its 64-column boxes and its
// tail box) from rows `row`.. of head `head`, batch row `b`, completing on
// `bar`
template <int HDP, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* main,
                                          const CUtensorMap* tail, uint64_t* bar, int head,
                                          int row, int b) {
  using L = Layout<HDP, ROWS>;
  for (int kb = 0; kb < L::kMain; ++kb)
    tma_load_4d(dst + kb * L::kBox, main, bar, kb * 64, head, row, b);
  if (L::kTailCols) tma_load_4d(dst + L::kMain * L::kBox, tail, bar, L::kMain * 64, head, row, b);
}

// The key count the TPU wrapper pads S to: 128 (short_attention.py:192-205)
// or, for the prefix-LM kernel, its key block min(512, S rounded up to 128)
// (prefix_flash.py:349-360).
template <bool kPrefix>
__device__ __forceinline__ int padded_keys(int S) {
  const int s128 = (S + 127) / 128 * 128;
  if constexpr (!kPrefix) return s128;
  const int bk = s128 < 512 ? s128 : 512;
  return (S + bk - 1) / bk * bk;
}

// The forward kernel's body (the header comment); a __global__ kernel of
// kThreads threads with one block per SM calls it with its six tensor maps
// (q, k, v as 64-column boxes of 128 rows, then their tail boxes).  Kernel
// #1: q_side / kv_side the segment ids [B, T] / [B, S] (both null for no
// mask), lse null.  Kernel #10: q_side plen [B], kv_side kv_valid [B, S],
// lse [B, Hq, T].  The kernels pass these one by one: read through a
// struct parameter, kernel #1 ran 2 % slower at the SigLIP shape on an
// H100.
template <int HDP, bool kPrefix>
__device__ __forceinline__ void flash_fwd(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, const CUtensorMap* tt_q,
                                          const CUtensorMap* tt_k, const CUtensorMap* tt_v,
                                          const int32_t* q_side, const int32_t* kv_side,
                                          __nv_bfloat16* out, float* lse, int T, int S, int Hq,
                                          int Hkv, int hd, float scale_log2) {
  using L = Layout<HDP>;
  constexpr int TILE = L::kTile;  // bytes of one Q, K or V tile

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  __shared__ __align__(16) int32_t segs[kStages][kBN];
  __shared__ int key_range[2];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sKV = sQ + TILE;  // stage s: K at 2 s TILE, V at (2 s + 1) TILE

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int hk = h / (Hq / Hkv);
  const bool masked = kPrefix || q_side != nullptr;
  const int plen = kPrefix ? q_side[b] : 0;
  const int32_t* kv_row = masked ? kv_side + static_cast<long>(b) * S : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    key_range[0] = S;
    key_range[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the K/V tiles this CTA visits: all of them, or (prefix-LM) those that
  // hold a key one of its rows sees unless one of its rows sees none
  int j_lo = 0, j_hi = (S + kBN - 1) / kBN;
  if constexpr (kPrefix) {
    const int2 keys = valid_key_range(kv_row, S, key_range);
    const int q_end = min(q0 + kBM, T);
    const bool blind = (q0 < plen && !(keys.y > 0 && keys.x < plen)) ||
                       (q_end > plen && keys.y == 0);
    if (!blind) {
      const int2 tiles = prefix_tiles(keys, plen, q0, q_end);
      j_lo = tiles.x;
      j_hi = tiles.y;
    }
  }
  const int n_kv = j_hi - j_lo;

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: it gives its registers to the consumers, and one
    // warp of it works: lane 0 issues the TMA copies, every lane copies the
    // tile's mask ints and arrives on the stage's barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(&q_full, TILE);
      load_tile<HDP, kBM>(sQ, tm_q, tt_q, &q_full, h, q0, b);
    }
    int stage = 0, phase = 0;
    for (int j = j_lo; j < j_hi; ++j) {
      const int kv0 = j * kBN;
      mbar_wait(&empty[stage], phase ^ 1);
      if (masked) {
        for (int c = lane; c < kBN; c += 32) {
          if constexpr (kPrefix) {
            segs[stage][c] = prefix_code(kv_row, kv0 + c, S, plen);
          } else {
            segs[stage][c] = kv0 + c < S ? kv_row[kv0 + c] : 0;
          }
        }
      }
      if (lane == 0) {
        unsigned char* k = sKV + 2 * stage * TILE;
        mbar_expect_tx(&full[stage], 2 * TILE);
        load_tile<HDP, kBN>(k, tm_k, tt_k, &full[stage], hk, kv0, b);
        load_tile<HDP, kBN>(k + TILE, tm_v, tt_v, &full[stage], hk, kv0, b);
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63;
  // this thread holds rows r0 and r0 + 8 of them, columns 8 j + 2 t4 (+1).
  // 384 threads get 168 registers each at launch; S, O and the in-flight
  // P fragments need more, and the producer's 4 x 144 cover 2 x 4 x 72
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int ta = q0 + wg * 64 + warp * 16 + (lane >> 2), tb = ta + 8;
  Rows r;
  r.qs0 = r.qs1 = 0;
  if constexpr (kPrefix) {
    r.qs0 = ta >= plen;
    r.qs1 = tb >= plen;
  } else if (masked) {
    r.qs0 = ta < T ? q_side[static_cast<long>(b) * T + ta] : 0;
    r.qs1 = tb < T ? q_side[static_cast<long>(b) * T + tb] : 0;
  }

  float o[HDP / 2], s[64];
  uint32_t pf[kBN / 16][4];  // bf16 p: the A fragments of the PV product
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;

  mbar_wait(&q_full, 0);
  // this warpgroup's 64 rows of Q: in the 64-column boxes and in the tail
  const unsigned char* q_wg = sQ + wg * 64 * 128;
  const unsigned char* q_tail = sQ + L::kMain * L::kBox + wg * 64 * L::kTailRow;
  // S = Q K^T: both K-major
  auto qk = [&](const unsigned char* k) {
    qk_product<HDP, kBN>(s, q_wg, q_tail, L::kBox, k, k + L::kMain * L::kBox, L::kBox);
  };

  // tile 0: S, then its softmax; every later tile j issues S_j and
  // P_{j-1} V_{j-1} together and takes the softmax of S_j while the PV
  // product runs (the P registers stay fenced until it has finished)
  if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
  mbar_wait(&full[0], 0);
  turn_wait(wg);
  wgmma_fence();
  qk(sKV);
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_acc(s);
  float alpha0, alpha1;
  softmax_tile<kPrefix>(s, segs[0], masked, S - j_lo * kBN, t4, scale_log2, r, alpha0, alpha1);
  pack_p<kBN>(s, pf);
  int prev = 0, stage = 0, phase = 0;
  for (int j = 1; j < n_kv; ++j) {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    mbar_wait(&full[stage], phase);
    const unsigned char* k = sKV + 2 * stage * TILE;
    turn_wait(wg);
    wgmma_fence();
    qk(k);
    wgmma_commit();
    pv_product<HDP, kBM, kBN / 16>(o, pf, sKV + 2 * prev * TILE + TILE, 0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
    fence_acc(s);
    softmax_tile<kPrefix>(s, segs[stage], masked, S - (j_lo + j) * kBN, t4, scale_log2, r,
                          alpha0, alpha1);
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pf);
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      o[4 * d + 0] *= alpha0;
      o[4 * d + 1] *= alpha0;
      o[4 * d + 2] *= alpha1;
      o[4 * d + 3] *= alpha1;
    }
    pack_p<kBN>(s, pf);
    prev = stage;
  }
  turn_wait(wg);
  wgmma_fence();
  pv_product<HDP, kBM, kBN / 16>(o, pf, sKV + 2 * prev * TILE + TILE, 0);
  wgmma_commit();
  if (wg == 0) turn_pass(wg);  // as many passes each way as waits
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(pf);
  float l0 = r.l0, l1 = r.l1;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // a row that saw no key (its max still the mask value) has l = S; the TPU
  // wrapper's zero pad keys add one each, so it divides by the padded count
  const float pad_keys = static_cast<float>(padded_keys<kPrefix>(S) - S);
  if (r.m0 <= kMaskValue) l0 += pad_keys;
  if (r.m1 <= kMaskValue) l1 += pad_keys;
  if constexpr (kPrefix) {
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    if (t4 == 0) {  // natural log; a row that saw no key keeps m = -1e30
      float* lse_row = lse + (static_cast<long>(b) * Hq + h) * T;
      if (ta < T) lse_row[ta] = (r.m0 <= kMaskValue ? kMaskValue : r.m0 * kLn2) + logf(l0);
      if (tb < T) lse_row[tb] = (r.m1 <= kMaskValue ? kMaskValue : r.m1 * kLn2) + logf(l1);
    }
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long q_stride = static_cast<long>(Hq) * hd;
  __nv_bfloat16* oa = out + (static_cast<long>(b) * T + ta) * q_stride + static_cast<long>(h) * hd;
  __nv_bfloat16* ob = oa + 8 * q_stride;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const int c = d * 8 + 2 * t4;
    if (d * 8 < hd) {  // hd % 8 == 0: the pair c, c + 1 is in range together
      if (ta < T) {
        *reinterpret_cast<uint32_t*>(oa + c) = pack_bf16x2(o[4 * d] * inv0, o[4 * d + 1] * inv0);
      }
      if (tb < T) {
        *reinterpret_cast<uint32_t*>(ob + c) =
            pack_bf16x2(o[4 * d + 2] * inv1, o[4 * d + 3] * inv1);
      }
    }
  }
}

// A contiguous bf16 [B, L, H, hd] tensor as boxes of `cols` head-dim
// columns x `rows` rows of one (head, batch), in the swizzle of a 2
// cols-byte row; the head-dim extent is hd, so the columns past it are
// zero-filled, and so are the rows past L.
inline bool encode_heads(CUtensorMap* map, const void* base, int B, int L, int H, int hd,
                         int cols, int rows = 128) {
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * H, row * H * L};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box, swizzle);
}

// The two maps of a tensor in Layout<HDP, rows>: its 64-column boxes and
// its tail box; a layout without one of the two gets the other in its
// place (the kernels do not read it).
template <int HDP>
bool encode_tile_maps(CUtensorMap* main, CUtensorMap* tail, const void* base, int B, int L,
                      int H, int hd, int rows = 128) {
  using Lay = Layout<HDP>;
  if ((Lay::kMain > 0 && !encode_heads(main, base, B, L, H, hd, 64, rows)) ||
      (Lay::kTailCols > 0 && !encode_heads(tail, base, B, L, H, hd, Lay::kTailCols, rows))) {
    return false;
  }
  if (Lay::kMain == 0) *main = *tail;
  if (Lay::kTailCols == 0) *tail = *main;
  return true;
}

}  // namespace flash
