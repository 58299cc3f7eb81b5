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
// of FlashAttention-3): one CTA per (128 query rows, q-head, batch) runs a
// producer warpgroup and two consumer warpgroups of 64 query rows each.
// One producer warp copies the Q tile once and K/V tiles of 128 keys into a
// three-stage ring in shared memory with TMA (4-D tensor maps over [B, L,
// H, hd]), together with the tile's key segment ids (plain loads into
// shared memory, so the mask is never re-read from device memory per
// element); `mbarrier` pairs order the ring.  A tile's head dim is copied
// as 64-column boxes in 128-byte swizzled rows plus, for hd 65-96 and up to
// 32, one narrow box of the last 16 or 32 columns in 32- or 64-byte
// swizzled rows (`Layout`): the maps' head-dim extent is hd, so TMA zero-
// fills the columns past it, which pads hd = 72 to the 80 of the QK^T
// depth with 8 columns of fill instead of the 56 a second 64-column box
// would copy, and the rows past T or S.  The maps are encoded on the host
// once per buffer and shape and then taken from a cache (hopper.cuh).  The
// producer warpgroup gives its registers to the consumers (`setmaxnreg`: 24
// and 240 of the 168 each thread has at launch; 128 x 24 + 256 x 240 is
// 384 x 168, so a build with fewer registers at entry would leave
// `setmaxnreg.inc` waiting: kernels.py refuses such a build).  Each
// consumer computes S = Q K^T with
// `wgmma.m64n128k16` (Q and K both K-major in shared memory), masks and
// rescales in f32 registers with exp2 (log2 e folded into the score scale;
// the finite -1e30 mask is set after the fold, so a tile with no visible key
// is still cleared by exp2(-1e30 - m) = 0 once a visible max arrives), packs
// the unnormalized p to bf16 in registers and feeds it as the A operand of
// O += P V (`wgmma.m64n{64,128,..}k16` over the 64-column boxes and one of
// width 16 or 32 over the narrow box; V the MN-major B operand through the
// transpose bit).  Inside a warpgroup the products are pipelined: S of tile
// j and P V of tile j - 1 are issued together, and the softmax of tile j
// runs while P V runs; across the two warpgroups two named barriers hand
// the tensor cores back and forth (ping-pong), so one warpgroup's softmax
// overlaps the other's products.  Keys past S get -inf (they leave the
// softmax); query rows past T are not stored; any S works, as K/V stream
// through the ring.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;       // query rows per CTA (64 per consumer warpgroup)
constexpr int kBN = 128;       // keys per streamed tile
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kBox = 64 * 128 * 2;         // one 64-column box of 128 rows
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// The head dim of one Q, K or V tile (128 rows) in shared memory: kMain
// boxes of 64 columns in 128-byte swizzled rows, then for HDP = 16, 32, 80
// or 96 a tail box of the last 16 or 32 columns in 32- or 64-byte swizzled
// rows.  (For hd = 72 a second 64-column box would be 56 columns of TMA
// zero fill, which costs the copy about as much as real data.)
template <int HDP>
struct Layout {
  static constexpr int kTailCols = HDP % 64 == 16 || HDP % 64 == 32 ? HDP % 64 : 0;
  static constexpr int kMain = (HDP - kTailCols) / 64 + ((HDP - kTailCols) % 64 != 0);
  static constexpr int kMainCols = kTailCols ? 64 * kMain : HDP;  // the main product's width
  static constexpr int kTailRow = 2 * kTailCols;                  // bytes of a tail row
  static constexpr int kTile = kMain * kBox + kBM * kTailRow;     // a multiple of 1024
};

// The P fragments stay live until the PV product that reads them is done
// (see hopper::fence_acc).
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

// S (64 x 128, f32) (+)= A (64 x 16, K-major smem) * B (16 x 128, K-major
// smem); scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O (64 x N, f32) (+)= P (64 x 16 bf16, A fragments in registers) * V (16 x
// N, MN-major smem: the transpose bit), one specialization per N.
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

// The online-softmax state of this thread's two query rows (log2 domain).
struct Rows {
  int qs0, qs1;                          // their segment ids
  float m0 = -INFINITY, m1 = -INFINITY;  // running max
  float l0 = 0.f, l1 = 0.f;              // running sum of the unrounded p
};

// One tile's scores (this thread's 2 x 32 of the 64 x 128 f32 tile) ->
// p = exp2(s * scale_log2 - m) in place.  Keys at or past `valid` get -inf
// (they leave the softmax); a segment mismatch gets the finite kMaskValue
// after the scale, so exp2(kMaskValue - m) is 0 once a visible key sets m,
// and a row that sees no key averages over all of them.  Updates m and l
// (from the unrounded f32 p, as the TPU kernel sums it) and returns the
// factors that rescale the earlier o.
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
          if (kseg != r.qs0) a = kMaskValue;
          if (kseg != r.qs1) bb = kMaskValue;
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
  alpha0 = ex2(r.m0 - mn0);
  alpha1 = ex2(r.m1 - mn1);
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

// p (f32 accumulator layout) -> bf16 pairs in the A-fragment layout of the
// PV product: k16 step kk holds keys 16 kk .. 16 kk + 15
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&pf)[kBN / 16][4]) {
#pragma unroll
  for (int jj = 0; jj < kBN / 8; ++jj) {
    pf[jj >> 1][(jj & 1) * 2 + 0] = pack_bf16x2(s[4 * jj + 0], s[4 * jj + 1]);
    pf[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16x2(s[4 * jj + 2], s[4 * jj + 3]);
  }
}

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
  using L = Layout<HDP>;
  constexpr int KSTEPS = HDP / 16;  // k16 steps of QK^T
  constexpr int TILE = L::kTile;    // bytes of one Q, K or V tile

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  __shared__ __align__(16) int32_t segs[kStages][kBN];
  // 128-byte swizzled tiles sit on 1024-byte boundaries
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sKV = sQ + TILE;  // stage s: K at 2 s TILE, V at (2 s + 1) TILE

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int hk = h / (Hq / Hkv);
  const int n_kv = (S + kBN - 1) / kBN;
  const bool masked = q_seg != nullptr;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: it gives its registers to the consumers, and one
    // warp of it works: lane 0 issues the TMA copies, every lane copies the
    // tile's key segment ids and arrives on the stage's barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    // one tile: its 64-column boxes and its tail box
    auto load = [&](unsigned char* dst, const CUtensorMap* main, const CUtensorMap* tail,
                    uint64_t* bar, int head, int row) {
      for (int kb = 0; kb < L::kMain; ++kb) tma_load_4d(dst + kb * kBox, main, bar, kb * 64, head, row, b);
      if (L::kTailCols) tma_load_4d(dst + L::kMain * kBox, tail, bar, L::kMain * 64, head, row, b);
    };
    if (lane == 0) {
      mbar_expect_tx(&q_full, TILE);
      load(sQ, &tm_q, &tt_q, &q_full, h, q0);
    }
    int stage = 0, phase = 0;
    for (int j = 0; j < n_kv; ++j) {
      const int kv0 = j * kBN;
      mbar_wait(&empty[stage], phase ^ 1);
      if (masked) {
        for (int c = lane; c < kBN; c += 32) {
          segs[stage][c] = kv0 + c < S ? kv_seg[static_cast<long>(b) * S + kv0 + c] : 0;
        }
      }
      if (lane == 0) {
        unsigned char* k = sKV + 2 * stage * TILE;
        mbar_expect_tx(&full[stage], 2 * TILE);
        load(k, &tm_k, &tt_k, &full[stage], hk, kv0);
        load(k + TILE, &tm_v, &tt_v, &full[stage], hk, kv0);
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
  if (masked) {
    r.qs0 = ta < T ? q_seg[static_cast<long>(b) * T + ta] : 0;
    r.qs1 = tb < T ? q_seg[static_cast<long>(b) * T + tb] : 0;
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
  const unsigned char* q_tail = sQ + L::kMain * kBox + wg * 64 * L::kTailRow;
  // S = Q K^T: both K-major; a k16 step is 32 bytes along a swizzled row
  auto qk = [&](const unsigned char* k) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk < 4 * L::kMain) {
        const int kb = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_bf16_n128(s, smem_desc<128>(q_wg + kb * kBox + off, 16),
                           smem_desc<128>(k + kb * kBox + off, 16), kk > 0);
      } else if constexpr (L::kTailCols > 0) {
        const int off = (kk - 4 * L::kMain) * 32;
        wgmma_ss_bf16_n128(s, smem_desc<L::kTailRow>(q_tail + off, 16),
                           smem_desc<L::kTailRow>(k + L::kMain * kBox + off, 16), kk > 0);
      }
    }
  };
  // O += P V: V is MN-major (head dim contiguous), 16 keys are 16 rows;
  // the 64-column boxes one box apart, the tail in a product of its own
  auto pv = [&](const unsigned char* k) {
    const unsigned char* v = k + TILE;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      if constexpr (L::kMainCols > 0) {
        wgmma_rs<L::kMainCols>(*reinterpret_cast<float(*)[L::kMainCols / 2]>(o), pf[kk],
                               smem_desc<128>(v + kk * 16 * 128, kBox), 1);
      }
      if constexpr (L::kTailCols > 0) {
        wgmma_rs<L::kTailCols>(*reinterpret_cast<float(*)[L::kTailCols / 2]>(o + L::kMainCols / 2),
                               pf[kk], smem_desc<L::kTailRow>(v + L::kMain * kBox + kk * 16 * L::kTailRow,
                                                             kBM * L::kTailRow), 1);
      }
    }
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
  softmax_tile(s, segs[0], masked, S, t4, scale_log2, r, alpha0, alpha1);
  pack_p(s, pf);
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
    pv(sKV + 2 * prev * TILE);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
    fence_acc(s);
    softmax_tile(s, segs[stage], masked, S - j * kBN, t4, scale_log2, r, alpha0, alpha1);
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
    pack_p(s, pf);
    prev = stage;
  }
  turn_wait(wg);
  wgmma_fence();
  pv(sKV + 2 * prev * TILE);
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
// columns x 128 rows of one (head, batch), in the swizzle of a 2 cols-byte
// row; the head-dim extent is hd, so the columns past it are zero-filled.
bool encode_heads(CUtensorMap* map, const void* base, int B, int L, int H, int hd, int cols) {
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * H, row * H * L};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, 128, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box, swizzle);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const int32_t* q_seg,
           const int32_t* kv_seg, void* out, int B, int T, int S, int Hq, int Hkv, int hd,
           float scale, cudaStream_t stream) {
  static_assert(kBM == 128 && kBN == 128, "the tensor maps' boxes are 128 rows");
  using L = Layout<HDP>;
  constexpr int smem = (1 + 2 * kStages) * L::kTile + 1024;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(short_attention_kernel<HDP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // the 64-column maps and the tail maps; a layout without one of the two
  // passes the other in its place (the kernel does not read it)
  CUtensorMap maps[6];
  const void* base[3] = {q, k, v};
  const int rows[3] = {T, S, S}, heads[3] = {Hq, Hkv, Hkv};
  for (int i = 0; i < 3; ++i) {
    CUtensorMap* m = &maps[i];
    CUtensorMap* t = &maps[3 + i];
    if ((L::kMain > 0 && !encode_heads(m, base[i], B, rows[i], heads[i], hd, 64)) ||
        (L::kTailCols > 0 &&
         !encode_heads(t, base[i], B, rows[i], heads[i], hd, L::kTailCols))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (L::kMain == 0) *m = *t;
    if (L::kTailCols == 0) *t = *m;
  }
  const dim3 grid((T + kBM - 1) / kBM, Hq, B);
  short_attention_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), T, S, Hq, Hkv, hd,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
