// Grouped-int4 W4A8 matmul for Hopper (sm_90a): every LM linear of the
// unfused int4 serving layout (batched prefill and decode).  Two kernels,
// chosen by the row count T alone (ops/w4_grouped.py): T <= 256 takes the
// decode kernel, more rows the prefill kernel.
//
// Replaces: lavida_mod_tpu/ops/pallas_w4.py::w4_matmul_grouped (per-token
// int8 activations times int4 weights with one f32 scale per 128-row group
// and column, bf16 out).  The activation codes come from the row
// quantization kernel of w4_fused.cu (`lavida_act_quant`, formula 2:
// sx = max(amax, 1e-8) * f32(1/127), the TPU wrapper's `/ 127.0` as XLA
// compiles it), as the TPU wrapper quantizes outside its kernel.  The TPU
// kernel splits the same two regimes (pallas_w4.py:179-182: the decode
// keeps block_t = T).
//
// The TPU kernel's f32 order, kept bit for bit by both: inside each k-block
// of `gb` groups (2048 packed rows, 32 groups, at the LLaDA widths) a
// partial sum starts at 0 and takes part + d_g * s_g group by group (d_g
// the exact int32 dot of the group); each finished partial is added to the
// accumulator; the epilogue is bf16(acc * sx).  Multiplies and adds are
// IEEE (__fmul_rn / __fadd_rn): no contraction into FMA.
//
// What bounds it on the H100 (LLaDA-8B, B = 4):
//   - the prefill, T = 4608 rows: 2 * 4608 * 6.98 G = 64.3 T integer ops per
//     batch, 32.5 ms at 1,979 TOP/s -- the int8 tensor cores;
//   - a decode step, T = 128 rows: 3.7 GB of int4 weights and scales,
//     1.1 ms at 3.35 TB/s -- the weight stream -- against 0.90 ms of int8
//     products and about as long again for the per-group f32 flush, which
//     touches every output once per group.  At T = 256 (B = 8) the
//     products and the flush bound it.  Besides, every unit (64 columns)
//     reads its rows of codes through L2: 32 MB per [128, 4096] x 4096
//     call, 3.6 times the weights.
//
// The decode kernel (`w4_decode_kernel`): a weight-streaming wgmma GEMM in
// the swap-AB form out^T [N, T] = W^T [N, K] . X^T [K, T].
//   - The weights are wgmma's A operand, in registers
//     (`wgmma.m64nRBk32.s32.s8.s8` with A from registers).  A warp's A
//     fragment of a k-step is laid out as mma.m16n8k32's (rows gid and gid
//     + 8 of its 16, k tig * 4 and 16 + tig * 4; CUTLASS's ALayout_64x32),
//     so the B fragments of two n8 tiles of the fragment layout
//     (ops/quant.py) are one A fragment after a widening in registers
//     ((w << 4) & 0xF0F0F0F0, w & 0xF0F0F0F0: 16 x the codes).
//     A warpgroup covers 64 columns.
//   - The activation codes are the B operand, K-major in shared memory with
//     the 128-byte swizzle: one 128-byte row per token and group, brought
//     by TMA, which zero-fills the rows past T (masked at the store).
//   - A unit is 64 columns by RB rows (16, 32, 48 or 64: the wgmma N).
//     One consumer warpgroup per CTA; persistent CTAs, one per SM, own
//     contiguous runs of units, the row blocks of a column tile next to
//     each other, so a tile's later reads of its weights come from L2.  The
//     plan (rows per unit, CTAs, stages) is ops/w4_grouped.py::decode_plan.
//   - A producer thread keeps a ring of stages of kDecSG (4) groups filled
//     by TMA: one 3D copy brings the 8 tiles' weights of a stage, one 2D
//     copy their scales, one 2D copy per group the unit's rows of codes.  Its
//     first stages' weights and scales are issued before
//     `griddepcontrol.wait`, so they stream while the row quantization
//     before it runs (programmatic dependent launch).
//   - Two groups' products are in flight: group g + 1's are issued, into a
//     second accumulator, before group g is flushed, in a pipeline that is
//     the same in every iteration (a data-dependent wgmma issue or wait
//     makes ptxas serialize every product).  Each group's first product
//     overwrites its accumulator (scale-d 0).
//   - The flush: the exact int32 d (|d| < 2^22, so cvt.rn.f32.s32 is
//     exact), times the scale / 16 (which folds in the widening's 16
//     exactly), added to `part`.  `total` and `part` stay in registers
//     (RB / 2 each a thread), the unit's row scales too.
//
// The prefill kernel (`w4_prefill_kernel`): the same swap-AB product and
// flush on #3's shape (w8a8_matmul.cu), a persistent wgmma GEMM.
//   - A unit is 128 columns by 128 rows: two consumer warpgroups of 64
//     columns each (wgmma.m64n128k32 with A from registers, as above), one
//     CTA per SM with a producer warpgroup.  Per group a unit reads 8 KB of
//     weights and 16 KB of codes through L2 for 4.2 M int8 ops, about 170
//     ops a byte (the first design's 64 x 64 mma.sync tile: 85).  Its
//     accumulator, `part` and `total` are 64 registers each a thread: the
//     producer warpgroup gives its registers to the consumers (setmaxnreg
//     24 / 240).
//   - The producer's one thread keeps a ring of two stages of kPreSG (4)
//     groups filled by TMA, as the decode kernel's: the 16 tiles' weights
//     in one 3D box, their scales in one 2D box, the codes of each group in
//     a 2D box of 128 rows (zero-filled past T); the first stages' weights
//     and scales are issued before `griddepcontrol.wait`.
//   - Each warpgroup issues a group's four products, waits for them and
//     flushes them; the two warpgroups share the tensor cores.  A group's
//     flush is 192 instructions a thread (convert, multiply, add for 64
//     outputs) against its products' 256 tensor-core cycles per
//     warpgroup, so at the bound the SM's instruction issue would be
//     nearly as busy as its tensor cores.  What holds it is the consumers:
//     their products and their flush take about as long each and add up
//     rather than overlap; the ring alone takes about half the kernel's
//     time and is hidden behind them.  A second group or half group in
//     flight per warpgroup spills registers, and turns between the
//     warpgroups through named barriers moved it by no more than 3 %
//     (PERF.md §6, #4's prefill).
//   - The pipeline is the same in every iteration: a stage's every group
//     is issued, and those past the last group are not flushed.
//   - The CTAs walk the units with the column tiles inner, so the units in
//     flight share their row blocks' codes and every column tile's weights
//     in L2; each warpgroup keeps its unit's row scales in shared memory
//     for the epilogue.  The plan (column tiles, row blocks, CTAs, stages)
//     is ops/w4_grouped.py::prefill_plan.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w4_stream.cuh"

namespace {

constexpr int kGroup = 128;

// ---------------------------------------------------------------------------
// the decode regime: T <= kDecMaxRows
// ---------------------------------------------------------------------------
// The plan's constants, mirrored by ops/w4_grouped.py (DECODE_*; a CPU test
// reads them here).
constexpr int kDecMaxRows = 256;      // rows of the decode regime
constexpr int kDecSG = 4;             // groups per stage
constexpr int kDecMaxStages = 8;
constexpr int kDecCols = 64;          // columns per unit: one wgmma M
constexpr int kDecThreads = 128 + 32; // the consumer warpgroup and the producer warp
constexpr int kDecWBytes = 8 * kDecSG * 512;   // a stage's weights: 8 n8 tiles
constexpr int kDecSBytes = 1024;      // a stage's scales (kDecSG x 64 f32)
constexpr int kSmemLimit = 232448;
static_assert(kDecSG * kDecCols * 4 <= kDecSBytes && kDecSBytes % 1024 == 0,
              "a stage's scales fit their 1024-byte-aligned region");

// a stage: the weights, the codes of the unit's rb rows group by group, the
// scales; every size keeps the next stage on the swizzle's 1024-byte
// boundary
__host__ __device__ constexpr int dec_stage_bytes(int rb) {
  return kDecWBytes + kDecSG * rb * kGroup + kDecSBytes;
}
// the ring on a 1024-byte boundary in dynamic shared memory
__host__ __device__ constexpr int dec_smem(int rb, int stages) {
  return 1024 + stages * dec_stage_bytes(rb);
}

// D (64 x RB s32) (+)= A (64 x 32 s8, registers) * B (32 x RB s8, K-major
// shared memory, 128-byte swizzle); scale_d = 0 overwrites D, which the
// tensor cores then need not read.  One overload per RB.
__device__ __forceinline__ void wgmma_rs(int (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(int (&d)[24], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The prefill's product: D (64 x 128 s32) (+)= A (64 x 32 s8, registers) *
// B (32 x 128 s8, K-major shared memory, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// One CTA: a consumer warpgroup and a producer warp (one thread issues
// every copy).  Warp w of the warpgroup takes the unit's columns 16 w + gid
// and 16 w + gid + 8 (its fragment rows); its lane's accumulator element
// 4 j + e holds the token 8 j + 2 tig + (e & 1) of the unit's RB rows and
// the column of row gid + 8 (e >> 1).  A stage holds [the 8 tiles' weights
// | the codes, group by group | the scales].  Two groups' products are in
// flight: group g + 1's are issued, into a second accumulator, before
// group g is flushed.  Stage, unit and k-block positions are counted, not
// divided, in the loops.
template <int RB>
__global__ void __launch_bounds__(kDecThreads, 1)
w4_decode_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_s, const float* __restrict__ sx,
                 __nv_bfloat16* __restrict__ out, int T, int G, int N, int gb, int row_blocks,
                 int stages) {
  constexpr int kStage = dec_stage_bytes(RB);
  constexpr int kCodes = kDecWBytes;          // offsets inside a stage
  constexpr int kScales = kDecWBytes + kDecSG * RB * kGroup;
  constexpr int kAcc = RB / 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kDecMaxStages], empty[kDecMaxStages];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  // CTA c owns units [c * units / ctas, (c + 1) * units / ctas), unit u
  // the column tile u / row_blocks and the row block u % row_blocks
  const int units = N / kDecCols * row_blocks;
  const int u0 = static_cast<int>(static_cast<long>(blockIdx.x) * units / gridDim.x);
  const int u1 = static_cast<int>(static_cast<long>(blockIdx.x + 1) * units / gridDim.x);
  const int nslices = (G + kDecSG - 1) / kDecSG;
  const int total = (u1 - u0) * nslices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {   // the producer
    if (threadIdx.x == 128) {
      // a stage's position: its slot and pass through the ring, its unit
      // (column tile, row block) and its slice of groups
      struct Pos {
        int slot, pass, tile, rblk, j;
      };
      auto advance = [&](Pos& q) {
        if (++q.slot == stages) q.slot = 0, ++q.pass;
        if (++q.j == nslices) {
          q.j = 0;
          if (++q.rblk == row_blocks) q.rblk = 0, ++q.tile;
        }
      };
      // the weights and scales are independent of the kernel before
      auto weights = [&](const Pos& q) {
        const int ng = min(kDecSG, G - q.j * kDecSG);
        uint64_t* bar = &full[q.slot];
        unsigned char* st = ring + q.slot * kStage;
        hopper::mbar_expect_tx(bar, kDecWBytes + kDecSG * kDecCols * 4 + ng * RB * kGroup);
        hopper::tma_load_3d(st, &tm_w, bar, 0, 2 * q.j * kDecSG, q.tile * 8);
        hopper::tma_load_2d(st + kScales, &tm_s, bar, q.tile * kDecCols, q.j * kDecSG);
      };
      auto codes = [&](const Pos& q) {
        const int ng = min(kDecSG, G - q.j * kDecSG);
        unsigned char* st = ring + q.slot * kStage + kCodes;
        for (int gi = 0; gi < ng; ++gi)
          hopper::tma_load_2d(st + gi * RB * kGroup, &tm_x, &full[q.slot],
                              (q.j * kDecSG + gi) * kGroup, q.rblk * RB);
      };
      const Pos start{0, 0, u0 / row_blocks, u0 % row_blocks, 0};
      const int pro = min(stages, total);
      Pos q = start;
      for (int k = 0; k < pro; ++k, advance(q)) weights(q);
      hopper::griddep_wait();
      Pos c = start;
      for (int k = 0; k < pro; ++k, advance(c)) codes(c);
      for (int k = pro; k < total; ++k, advance(q)) {
        w4s::bar_wait(&empty[q.slot], (q.pass - 1) & 1);
        weights(q);
        codes(q);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t ring_s = hopper::smem_u32(ring);
  // this lane's A fragments in a stage, its scales, and the descriptor of
  // the codes of a stage's first group in slot 0
  const uint32_t w_off = (2 * warp * kDecSG) * 512 + lane * 16;
  const uint32_t s_off = kScales + (warp * 16 + gid) * 4;
  const uint64_t desc0 = hopper::sw128_desc(ring + kCodes);
  hopper::griddep_wait();   // the epilogue reads the row scales of the pass before

  // group g's accumulator, A fragments and two scales / 16 are buffer
  // g & 1; the next group's weights and scales are loaded a group ahead
  int acc[2][kAcc];
  uint32_t a[2][4][4];
  float sc[2][2], part[kAcc], tot[kAcc];
  uint4 nw[2];
  float ns[2];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i] = tot[i] = 0.0f;
  auto load = [&](int slot, int gi) {   // this warp's 16 rows of A: tiles 2 warp, 2 warp + 1
    const uint32_t st = ring_s + slot * kStage + w_off + gi * 512;
    nw[0] = lds128(st);
    nw[1] = lds128(st + kDecSG * 512);
    const uint32_t ss = ring_s + slot * kStage + s_off + gi * kDecCols * 4;
    ns[0] = lds_f32(ss);
    ns[1] = lds_f32(ss + 32);
  };
  // group gi of the stage in `slot` (loaded) into buffer b: widened, its
  // four products issued, the first overwriting acc; then the next group
  // of the stage loaded
  auto issue = [&](int slot, int gi, int b) {
    const uint32_t v0[4] = {nw[0].x, nw[0].y, nw[0].z, nw[0].w};
    const uint32_t v1[4] = {nw[1].x, nw[1].y, nw[1].z, nw[1].w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[b][s][0] = (v0[s] << 4) & 0xF0F0F0F0u;
      a[b][s][1] = (v1[s] << 4) & 0xF0F0F0F0u;
      a[b][s][2] = v0[s] & 0xF0F0F0F0u;
      a[b][s][3] = v1[s] & 0xF0F0F0F0u;
    }
    sc[b][0] = ns[0] * 0.0625f;
    sc[b][1] = ns[1] * 0.0625f;
    const uint64_t db = desc0 + ((slot * kStage + gi * RB * kGroup) >> 4);
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_rs(acc[b], a[b][s], db + 2 * s, s);
    hopper::wgmma_commit();
    if (gi + 1 < kDecSG) load(slot, gi + 1);
  };
  // once buffer b's products are done: part + d * s / 16 per output;
  // `last` ends a k-block, whose partial goes into the total
  auto flush = [&](int b, bool last) {
    hopper::fence_acc(acc[b]);
#pragma unroll
    for (int s = 0; s < 4; ++s) hopper::fence_acc(a[b][s]);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const float d = __int2float_rn(acc[b][i]);   // exact: |d| < 2^22
      part[i] = __fadd_rn(part[i], __fmul_rn(d, sc[b][(i >> 1) & 1]));
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        tot[i] = __fadd_rn(tot[i], part[i]);
        part[i] = 0.0f;
      }
    }
  };

  // The products' pipeline is the same in every iteration, so that ptxas
  // can follow which group each wait retires and keeps the products in
  // flight (a data-dependent issue or wait makes it serialize every
  // wgmma): every group of a stage is issued even when the unit's last
  // stage has fewer (their products, on stale codes, are not flushed), and
  // the last stage issues a first group again that nothing reads.  Group
  // g's products go to acc[g & 1].
  static_assert(kDecSG % 2 == 0, "a stage's first group takes acc[0]");
  w4s::bar_wait(&full[0], 0);
  load(0, 0);
  issue(0, 0, 0);
  // stage k: ring slot and pass, slice j of its unit (column tile, row
  // block), groups left in the k-block
  int slot = 0, pass = 0, j = 0, tile = u0 / row_blocks, rblk = u0 % row_blocks, kleft = gb;
  // the unit's row scales of this lane's tokens, loaded at its first stage
  // and read at its epilogue
  float rs[RB / 4];
  for (int k = 0; k < total; ++k) {
    const int ng = min(kDecSG, G - j * kDecSG);
    const bool next = k + 1 < total;
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < RB / 4; ++i) {
        const int t = rblk * RB + 2 * tig + 8 * (i >> 1) + (i & 1);
        rs[i] = t < T ? sx[t] : 0.0f;
      }
    }
    int nslot = slot + 1, npass = pass;
    if (nslot == stages) nslot = 0, ++npass;
#pragma unroll
    for (int gi = 0; gi < kDecSG; ++gi) {
      // the next group's products (at the stage's end the next stage's
      // first), then this group's flush while they run
      if (gi + 1 < kDecSG) {
        issue(slot, gi + 1, (gi + 1) & 1);
      } else {
        if (next) w4s::bar_wait(&full[nslot], npass & 1);
        load(next ? nslot : slot, 0);
        issue(next ? nslot : slot, 0, 0);
      }
      hopper::wgmma_wait<1>();
      if (gi < ng) {
        flush(gi & 1, --kleft == 0);
        if (kleft == 0) kleft = gb;
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    slot = nslot;
    pass = npass;
    if (++j == nslices) {   // the unit's epilogue: bf16(total * sx)
      const long n = static_cast<long>(tile) * kDecCols + warp * 16 + gid;
      const int t0 = rblk * RB + 2 * tig;
#pragma unroll
      for (int jj = 0; jj < RB / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = t0 + 8 * jj + c;
          if (t < T) {
            __nv_bfloat16* o = out + static_cast<long>(t) * N + n;
            o[0] = __float2bfloat16_rn(__fmul_rn(tot[4 * jj + c], rs[2 * jj + c]));
            o[8] = __float2bfloat16_rn(__fmul_rn(tot[4 * jj + 2 + c], rs[2 * jj + c]));
          }
        }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) part[i] = tot[i] = 0.0f;
      j = 0;
      if (++rblk == row_blocks) rblk = 0, ++tile;
    }
  }
  hopper::wgmma_wait<0>();
}

template <int RB>
int launch_decode(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_s,
                  const float* sx, __nv_bfloat16* out, int T, int G, int N, int gb,
                  int row_blocks, int ctas, int stages, int smem, cudaStream_t st) {
  static int allowed = 0;
  const int err = hopper::allow_smem(w4_decode_kernel<RB>, smem, allowed);
  if (err) return err;
  return hopper::launch_dependent(w4_decode_kernel<RB>, dim3(ctas), dim3(kDecThreads), smem, st,
                                  tm_x, tm_w, tm_s, sx, out, T, G, N, gb, row_blocks, stages);
}

// ---------------------------------------------------------------------------
// the prefill regime: T > kDecMaxRows
// ---------------------------------------------------------------------------
// The plan's constants, mirrored by ops/w4_grouped.py (PREFILL_*; a CPU test
// reads them here).
constexpr int kPreRows = 128;         // rows per unit: the wgmma N
constexpr int kPreCols = 128;         // columns per unit: two warpgroups' wgmma M
constexpr int kPreSG = 4;             // groups per stage
constexpr int kPreMaxStages = 8;
constexpr int kPreConsumers = 256;    // two consumer warpgroups
constexpr int kPreThreads = kPreConsumers + 128;   // and the producer warpgroup
constexpr int kPreWBytes = 16 * kPreSG * 512;      // a stage's weights: 16 n8 tiles
constexpr int kPreXBytes = kPreSG * kPreRows * kGroup;   // its codes
constexpr int kPreSBytes = 2048;      // its scales (kPreSG x 128 f32)
constexpr int kPreStage = kPreWBytes + kPreXBytes + kPreSBytes;
static_assert(kPreSG * kPreCols * 4 <= kPreSBytes && kPreStage % 1024 == 0,
              "a stage's scales fit their region and stages stay on the swizzle's boundary");

// the ring on a 1024-byte boundary in dynamic shared memory
__host__ __device__ constexpr int pre_smem(int stages) { return 1024 + stages * kPreStage; }

// One CTA: two consumer warpgroups and a producer warpgroup, which gives its
// registers to the consumers (setmaxnreg 24 / 240; ptxas must give the
// kernel 168 at entry, kernels.REGISTERS_AT_ENTRY).  Warpgroup wg takes the
// unit's columns 64 wg .. 64 wg + 63; its warp w the columns 16 w + gid and
// 16 w + gid + 8 of them (its fragment rows), and its lane's accumulator
// element 4 j + e the token 8 j + 2 tig + (e & 1) of the unit's 128 rows and
// the column of row gid + 8 (e >> 1).  A stage holds [the 16 tiles' weights
// | the codes, group by group | the scales].  Each warpgroup issues a
// group's four products, waits for them and flushes them.  CTA c owns the units c, c + ctas, ...; unit u is the row
// block u / col_tiles and the column tile u % col_tiles, so the CTAs in
// flight cover a few row blocks across all column tiles.
__global__ void __launch_bounds__(kPreThreads, 1)
w4_prefill_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_s, const float* __restrict__ sx,
                  __nv_bfloat16* __restrict__ out, int T, int G, int N, int gb, int col_tiles,
                  int units, int stages) {
  constexpr int kCodes = kPreWBytes;   // offsets inside a stage
  constexpr int kScales = kPreWBytes + kPreXBytes;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kPreMaxStages], empty[kPreMaxStages];
  __shared__ float row_scales[2][kPreRows];   // each warpgroup's unit's sx
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int ctas = static_cast<int>(gridDim.x);
  const int nslices = (G + kPreSG - 1) / kPreSG;
  const int total = ((units - 1 - static_cast<int>(blockIdx.x)) / ctas + 1) * nslices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kPreConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kPreConsumers) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kPreConsumers) {
      // a stage's position: its slot and pass through the ring, its unit
      // and its slice of groups
      struct Pos {
        int slot, pass, u, j;
      };
      auto advance = [&](Pos& q) {
        if (++q.slot == stages) q.slot = 0, ++q.pass;
        if (++q.j == nslices) q.j = 0, q.u += ctas;
      };
      // the weights and scales are independent of the kernel before
      auto weights = [&](const Pos& q) {
        const int ng = min(kPreSG, G - q.j * kPreSG);
        const int tile = q.u % col_tiles;
        uint64_t* bar = &full[q.slot];
        unsigned char* dst = ring + q.slot * kPreStage;
        hopper::mbar_expect_tx(bar, kPreWBytes + kPreSG * kPreCols * 4 + ng * kPreRows * kGroup);
        hopper::tma_load_3d(dst, &tm_w, bar, 0, 2 * q.j * kPreSG, tile * 16);
        hopper::tma_load_2d(dst + kScales, &tm_s, bar, tile * kPreCols, q.j * kPreSG);
      };
      auto codes = [&](const Pos& q) {
        const int ng = min(kPreSG, G - q.j * kPreSG);
        unsigned char* dst = ring + q.slot * kPreStage + kCodes;
        const int r0 = q.u / col_tiles * kPreRows;
        for (int g = 0; g < ng; ++g)
          hopper::tma_load_2d(dst + g * kPreRows * kGroup, &tm_x, &full[q.slot],
                              (q.j * kPreSG + g) * kGroup, r0);
      };
      const Pos start{0, 0, static_cast<int>(blockIdx.x), 0};
      const int pro = min(stages, total);
      Pos q = start;
      for (int k = 0; k < pro; ++k, advance(q)) weights(q);
      hopper::griddep_wait();
      Pos c = start;
      for (int k = 0; k < pro; ++k, advance(c)) codes(c);
      for (int k = pro; k < total; ++k, advance(q)) {
        w4s::bar_wait(&empty[q.slot], (q.pass - 1) & 1);
        weights(q);
        codes(q);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t ring_s = hopper::smem_u32(ring);
  // this lane's A fragments in a stage (n8 tiles 8 wg + 2 warp and the next),
  // its two scales, and the descriptor of the codes of a stage's first group
  // in slot 0
  const uint32_t w_off = (8 * wg + 2 * warp) * kPreSG * 512 + lane * 16;
  const uint32_t s_off = kScales + (64 * wg + 16 * warp + gid) * 4;
  const uint64_t desc0 = hopper::sw128_desc(ring + kCodes);
  hopper::griddep_wait();   // the row scales come from the pass before

  int acc[64];
  uint32_t a[4][4];
  float part[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = tot[i] = 0.0f;
  // stage k: ring slot and pass, slice j of unit u, groups left in the
  // k-block
  int slot = 0, pass = 0, j = 0, u = static_cast<int>(blockIdx.x), kleft = gb;
  for (int k = 0; k < total; ++k) {
    // at a unit's first stage each thread of the warpgroup fetches one of
    // its row scales, stored once the stage's products are done
    float rs = 0.0f;
    if (j == 0) {
      const int t = u / col_tiles * kPreRows + (threadIdx.x & 127);
      if (t < T) rs = sx[t];
    }
    const int ng = min(kPreSG, G - j * kPreSG);
    w4s::bar_wait(&full[slot], pass & 1);
    const uint32_t st = ring_s + slot * kPreStage;
#pragma unroll
    for (int gi = 0; gi < kPreSG; ++gi) {
      // group gi, widened (16 x the codes), its four products issued and
      // waited for; every group of the stage is issued, so the products'
      // pipeline does not depend on data, and those past the last group
      // (stale codes) are not flushed
      const uint4 v0 = lds128(st + w_off + gi * 512);
      const uint4 v1 = lds128(st + w_off + (kPreSG + gi) * 512);
      const float s0 = lds_f32(st + s_off + gi * kPreCols * 4) * 0.0625f;
      const float s1 = lds_f32(st + s_off + gi * kPreCols * 4 + 32) * 0.0625f;
      const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
      const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        a[s][0] = (w0[s] << 4) & 0xF0F0F0F0u;
        a[s][1] = (w1[s] << 4) & 0xF0F0F0F0u;
        a[s][2] = w0[s] & 0xF0F0F0F0u;
        a[s][3] = w1[s] & 0xF0F0F0F0u;
      }
      const uint64_t db = desc0 + ((slot * kPreStage + gi * kPreRows * kGroup) >> 4);
      hopper::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs(acc, a[s], db + 2 * s, s);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) hopper::fence_acc(a[s]);
      // the flush: part + d * s / 16 per output (d exact: |d| < 2^22);
      // a k-block's last group adds its partial to the total
      if (gi < ng) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          part[i] = __fadd_rn(part[i], __fmul_rn(__int2float_rn(acc[i]), (i & 2) ? s1 : s0));
        if (--kleft == 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            tot[i] = __fadd_rn(tot[i], part[i]);
            part[i] = 0.0f;
          }
          kleft = gb;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    if (++slot == stages) slot = 0, ++pass;
    if (j == 0) row_scales[wg][threadIdx.x & 127] = rs;
    if (++j == nslices) {   // the unit is done: out = bf16(total * sx)
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int rblk = u / col_tiles;
      const int n = (u - rblk * col_tiles) * kPreCols + 64 * wg + 16 * warp + gid;
      if (n < N) {   // N % 128 = 64: the last tile's second warpgroup has no columns
#pragma unroll
        for (int jj = 0; jj < kPreRows / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 8 * jj + 2 * tig + c, t = rblk * kPreRows + r;
            if (t < T) {
              const float f = row_scales[wg][r];
              __nv_bfloat16* o = out + static_cast<long>(t) * N + n;
              o[0] = __float2bfloat16_rn(__fmul_rn(tot[4 * jj + c], f));
              o[8] = __float2bfloat16_rn(__fmul_rn(tot[4 * jj + 2 + c], f));
            }
          }
      }
      // the next unit's row scales overwrite these
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = 0.0f;
      j = 0;
      u += ctas;
    }
  }
}

}  // namespace

// The prefill regime (T > 256): out [T, N] bf16 = bf16(acc * sx) of the
// codes x8 [T, K] int8 with row scales sx [T] f32 (the row quantization
// launched just before, which this launch overlaps under programmatic
// dependent launch) against the fragment-layout weights packed [N/8, K/128,
// 512] and scales [K/128, N] f32; gb = groups per k-block (the TPU kernel's
// block_k / 64), dividing K/128; N a multiple of 64.  The plan
// (ops/w4_grouped.py::prefill_plan): the column tiles of 128 and row blocks
// of 128, the persistent CTAs, ring stages and dynamic shared bytes; a plan
// that does not match these constants is refused.  Returns a cudaError_t.
extern "C" int lavida_w4_grouped(const void* x8, const void* sx, const void* packed,
                                 const void* scales, void* out, int T, int K, int N, int gb,
                                 int col_tiles, int row_blocks, int ctas, int stages, int smem,
                                 void* stream) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  const int G = K / kGroup;
  if (T <= kDecMaxRows || K <= 0 || K % kGroup || N <= 0 || N % 64 || gb <= 0 || G % gb ||
      col_tiles != (N + kPreCols - 1) / kPreCols || row_blocks != (T + kPreRows - 1) / kPreRows ||
      ctas < 1 || ctas > col_tiles * row_blocks || stages < 2 || stages > kPreMaxStages ||
      smem != pre_smem(stages) || smem > kSmemLimit - 1024)
    return kBad;
  for (const void* p : {x8, packed, scales})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kBad;
  // the codes: K-major rows, 128-byte boxes of a unit's 128 rows, swizzled
  CUtensorMap tm_x, tm_w, tm_s;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(T)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t xb[2] = {kGroup, kPreRows};
  // the weights as [N/8 tiles][2G half groups][256 bytes]: one box is a
  // stage's 16 tiles x kPreSG groups
  const cuuint64_t wd[3] = {256, static_cast<cuuint64_t>(2 * G), static_cast<cuuint64_t>(N / 8)};
  const cuuint64_t ws[2] = {256, static_cast<cuuint64_t>(G) * 512};
  const cuuint32_t wb[3] = {256, 2 * kPreSG, 16};
  // the scales [G, N] f32: one box is a stage's kPreSG groups of 128 columns
  const cuuint64_t sd[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(G)};
  const cuuint64_t ss[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t sb[2] = {kPreCols, kPreSG};
  if (!hopper::encode_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x8, xd, xs, xb,
                          CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, packed, wd, ws, wb,
                          CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::encode_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, sd, ss, sb,
                          CU_TENSOR_MAP_SWIZZLE_NONE))
    return kBad;
  const auto st = static_cast<cudaStream_t>(stream);
  static int allowed = 0;
  const int err = hopper::allow_smem(w4_prefill_kernel, smem, allowed);
  if (err) return err;
  return hopper::launch_dependent(w4_prefill_kernel, dim3(ctas), dim3(kPreThreads), smem, st,
                                  tm_x, tm_w, tm_s, static_cast<const float*>(sx),
                                  static_cast<__nv_bfloat16*>(out), T, G, N, gb, col_tiles,
                                  col_tiles * row_blocks, stages);
}

// The decode regime (T <= 256): out [T, N] bf16 of the codes x8 [T, K]
// int8 with row scales sx [T] f32 (the row quantization launched just
// before, which this launch overlaps under programmatic dependent launch)
// against packed [N/8, K/128, 512] and scales [K/128, N] f32; gb groups per
// k-block.  The plan (ops/w4_grouped.py::decode_plan): rb rows per unit
// (16, 32, 48 or 64), row_blocks units along T, the persistent CTAs, ring
// stages and dynamic shared bytes; a plan that does not match these
// constants is refused.  Returns a cudaError_t.
extern "C" int lavida_w4_grouped_decode(const void* x8, const void* sx, const void* packed,
                                        const void* scales, void* out, int T, int K, int N,
                                        int gb, int rb, int row_blocks, int ctas, int stages,
                                        int smem, void* stream) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  const int G = K / kGroup, tiles = N / kDecCols;
  if (T <= 0 || T > kDecMaxRows || K <= 0 || K % kGroup || N <= 0 || N % kDecCols || gb <= 0 ||
      G % gb || (rb != 16 && rb != 32 && rb != 48 && rb != 64) || row_blocks < 1 ||
      row_blocks * rb < T || ctas < 1 || ctas > tiles * row_blocks ||
      stages < 2 || stages > kDecMaxStages || smem != dec_smem(rb, stages) ||
      smem > kSmemLimit - 1024)
    return kBad;
  for (const void* p : {x8, packed, scales})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kBad;
  // the codes: K-major rows, 128-byte boxes of a unit's rb rows, swizzled
  CUtensorMap tm_x, tm_w, tm_s;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(T)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t xb[2] = {kGroup, static_cast<cuuint32_t>(rb)};
  // the weights as [N/8 tiles][2G half groups][256 bytes]: one box is a
  // stage's 8 tiles x kDecSG groups
  const cuuint64_t wd[3] = {256, static_cast<cuuint64_t>(2 * G), static_cast<cuuint64_t>(N / 8)};
  const cuuint64_t ws[2] = {256, static_cast<cuuint64_t>(G) * 512};
  const cuuint32_t wb[3] = {256, 2 * kDecSG, 8};
  // the scales [G, N] f32: one box is a stage's kDecSG groups of 64 columns
  const cuuint64_t sd[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(G)};
  const cuuint64_t ss[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t sb[2] = {kDecCols, kDecSG};
  if (!hopper::encode_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x8, xd, xs, xb,
                          CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, packed, wd, ws, wb,
                          CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::encode_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, sd, ss, sb,
                          CU_TENSOR_MAP_SWIZZLE_NONE))
    return kBad;
  const auto* sp = static_cast<const float*>(sx);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (rb) {
    case 16:
      return launch_decode<16>(tm_x, tm_w, tm_s, sp, op, T, G, N, gb, row_blocks, ctas, stages,
                               smem, st);
    case 32:
      return launch_decode<32>(tm_x, tm_w, tm_s, sp, op, T, G, N, gb, row_blocks, ctas, stages,
                               smem, st);
    case 48:
      return launch_decode<48>(tm_x, tm_w, tm_s, sp, op, T, G, N, gb, row_blocks, ctas, stages,
                               smem, st);
    default:
      return launch_decode<64>(tm_x, tm_w, tm_s, sp, op, T, G, N, gb, row_blocks, ctas, stages,
                               smem, st);
  }
}
