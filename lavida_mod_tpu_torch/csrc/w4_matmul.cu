// Per-channel int4 weight matmul (bf16 activations) for Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/pallas_w4.py::w4_matmul (the Pallas TPU
// kernel that unpacks int4 weights in VMEM: x2 [2, T, K/2] bf16 holds the
// even and odd K columns of x, packed [K/2, N] int8 holds row 2k of W in
// the low nibble of byte k and row 2k + 1 in the high one, both signed;
// out = bf16((x_even @ lo + x_odd @ hi) * scale[n]) with f32 dots).  No
// model leaf or serving path of either package builds this layout: the
// int4 layouts use the grouped kernel (w4_grouped.cu).
//
// What bounds it on the H100: at decode widths ([32, 4096] x 12288) the
// 25 MB of packed weights, 7.6 us at 3.35 TB/s; at the prefill's T = 1056
// the bf16 tensor cores, 106 G flop, 0.107 ms.
//
// The design: a persistent swap-AB wgmma GEMM, out^T [N, T] = W^T [N, K] .
// x^T [K, T], in one kernel for every shape.
//   - A unit is 128 columns of W by BT rows of x (the wgmma N: 8, 16, 32
//     or 64 rows up to kDecMaxRows, the decode plan; 128 or 256 beyond, the
//     prefill plan) by a range of K.  The plan (ops/w4_matmul.py::plan)
//     picks BT, the K split and the CTAs from the shapes with a cost model
//     fitted to this kernel's times on an H100: K is split where the units
//     would leave most SMs idle (the ragged [5, 4304] x 1000: 8 units, 12
//     splits), not at the decode shape, where a unit's fixed cost (~4 us)
//     outweighs the 36 SMs the 96 units leave idle.
//   - A CTA is two consumer warpgroups, each owning 64 of the unit's
//     columns (one wgmma M), and a producer warpgroup, which gives its
//     registers to the consumers (setmaxnreg 56 / 224; ptxas must give the
//     kernel 168 at entry, kernels.REGISTERS_AT_ENTRY: the 256-row
//     instance's accumulator is 128 registers a thread).  The producer
//     keeps a ring of stages filled: a stage is kBK packed rows of the
//     unit's 128 columns of weights and the same kBK columns of x_even and
//     x_odd for the unit's rows, each tile in 128-byte rows with the
//     128-byte swizzle (x K-major, one row per token, as wgmma's B; the
//     weights one row per packed row, so the fragment loads below are
//     conflict-free), zero-filled past T, K/2 and N.  Where TMA takes an
//     operand (16-byte pitches and bases: N % 16 == 0 for the weights, K/2
//     % 8 == 0 for x) one thread brings its tile with one TMA copy, counted
//     on the stage's full barrier in bytes.  Else the warpgroup copies it
//     with cp.async in the largest granule of 16, 8 or 4 bytes that the row
//     pitch and the base allow (N = 1000 takes 8), plain loads below that,
//     into the same swizzled layout, and runs kStages - 2 stages ahead:
//     each thread waits for its copies of a stage, fences them into the
//     async proxy (wgmma reads x there) and arrives on the stage's full
//     barrier.  That handshake holds about one stage in flight (all by
//     cp.async, the decode shape took 0.041 ms against TMA's 0.026), so
//     TMA takes every operand it can.
//   - The weights are wgmma's A operand, in registers
//     (`wgmma.m64nBTk16.f32.bf16.bf16`, A from registers).  Warp w of a
//     warpgroup holds its rows 16 w .. 16 w + 15; lane (gid, tig) the rows
//     gid and gid + 8, which map to two adjacent columns of W (any map of
//     M rows to columns is a valid product, the epilogue writes through
//     the same one), so one 16-bit load of a packed row gives both rows'
//     bytes.  Per k16 step a thread loads packed rows 2 tig, 2 tig + 1,
//     2 tig + 8 and 2 tig + 9 (the swizzle puts the four rows' bytes in
//     four 16-byte chunks), pairs them with one `prmt` each and widens
//     nibbles to bf16 without a conversion: a nibble n in the low 4 bits
//     of each 16-bit half, (w & 0x000F000F) ^ 0x43084308 is the bf16 pair
//     136 + n (one lop3), and an fma by 1 and -136 leaves n exactly.  The
//     low nibbles make the A fragment of the lo product, the high ones
//     (the same word shifted by 4) that of the hi product: the lo product
//     runs against the x_even tile, the hi product against x_odd, both
//     into one f32 accumulator.
//   - Each k16 step issues its two products, loads the next step's packed
//     rows and waits for the step before (two steps' fragments in two
//     register buffers; four steps in flight measured the same).  The two
//     warpgroups share the tensor cores.  A stage's slot is released once
//     its last products are done.  What holds the decode shape (a clock64
//     timeline, w4_matmul_variants.py): ~860 cycles a stage, the same
//     without any loads, which is the widening (~300 cycles a stage,
//     issue-bound: 28 instructions a step a thread) and the 16 register-A
//     products of N = 32 (~350) one after the other; the prefill runs its
//     stages at ~87 % of the tensor cores' rate.
//   - The epilogue is bf16(acc * scale[n]) with an IEEE multiply, two
//     adjacent columns per 32-bit store.  A split unit stores its partial
//     sums (f32) to a workspace and counts itself on its tile's counter
//     (an integer atomic); the unit that finds the others done adds the
//     splits' partials in split order, so a call gives the same bits on
//     every run, and resets the counter.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w4_stream.cuh"

namespace {

// The plan's constants, mirrored by ops/w4_matmul.py (a CPU test reads
// them here).
constexpr int kBK = 64;               // packed rows (pairs of K) per stage
constexpr int kCols = 128;            // columns per unit: two warpgroups' wgmma M
constexpr int kDecMaxRows = 64;       // rows of the decode plan
constexpr int kMaxSplits = 16;        // K splits per unit
constexpr int kMaxStages = 8;
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kProducers = 128;       // and a producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kSmemLimit = 232448;

// a stage: x_even and x_odd tiles (BT rows of 128 bytes each), then the
// weights (kBK rows of kCols bytes); every size is a multiple of 1024, the
// swizzle's alignment
__host__ __device__ constexpr int stage_bytes(int bt) { return 2 * bt * 128 + kBK * kCols; }
__host__ __device__ constexpr int ring_stages(int bt) {
  return (kSmemLimit - 1024) / stage_bytes(bt) < kMaxStages
             ? (kSmemLimit - 1024) / stage_bytes(bt)
             : kMaxStages;
}
// the ring on a 1024-byte boundary in dynamic shared memory
__host__ __device__ constexpr int ring_smem(int bt) { return 1024 + ring_stages(bt) * stage_bytes(bt); }
static_assert(kBK * kCols % 1024 == 0 && kCols == 128,
              "the weights' rows are the swizzle's 128 bytes, a stage keeps its boundary");

// D (64 x N, f32) (+)= A (64 x 16 bf16, registers) * B (16 x N, K-major
// shared memory, 128-byte swizzle); scale_d = 0 overwrites D.  One
// specialization per N.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The nibbles in bits 0-3 and 16-19 of w as a bf16 pair, exactly: the
// magic exponent makes 136 + n, the fma takes 136 away.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t w) {
  uint32_t v, r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"   // (a & b) ^ c
      : "=r"(v) : "r"(w), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// A k16 step's fragments from the 16-bit loads of packed rows 2 tig, 2 tig
// + 1, 2 tig + 8 and 2 tig + 9 (byte 0: the column of row gid, byte 1 that
// of row gid + 8): a[0] the lo product's, a[1] the hi product's.
__device__ __forceinline__ void widen(uint32_t (&a)[2][4], uint32_t v0, uint32_t v1, uint32_t v8,
                                      uint32_t v9) {
  const uint32_t w01 = __byte_perm(v0, v1, 0x5410), w89 = __byte_perm(v8, v9, 0x5410);
  a[0][0] = nibbles_bf16(w01);
  a[1][0] = nibbles_bf16(w01 >> 4);
  a[0][1] = nibbles_bf16(w01 >> 8);
  a[1][1] = nibbles_bf16(w01 >> 12);
  a[0][2] = nibbles_bf16(w89);
  a[1][2] = nibbles_bf16(w89 >> 4);
  a[0][3] = nibbles_bf16(w89 >> 8);
  a[1][3] = nibbles_bf16(w89 >> 12);
}

// One granule of G bytes from global to shared memory, zeros where !ok:
// cp.async for 4 bytes and more (the source address is not read when
// !ok), plain loads and stores below.
template <int G>
__device__ __forceinline__ void copy_granule(unsigned char* dst, const unsigned char* src, bool ok) {
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else if constexpr (G >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src), "n"(G), "r"(ok ? G : 0)
                 : "memory");
  } else if constexpr (G == 2) {
    *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
  } else {
    *dst = ok ? *src : 0;
  }
}

// Byte b of row r in a tile of 128-byte rows with the 128-byte swizzle
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B): the row's 16-byte chunk c is stored
// at chunk c ^ (r & 7).
__host__ __device__ constexpr int swz(int r, int b) { return r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15)); }

// x_even and x_odd of rows t0 .. t0 + BT - 1 and packed columns k0 .. k0 +
// 63 into two swizzled tiles.
template <int BT, int G>
__device__ void copy_x(unsigned char* dst, const unsigned char* x2, long plane, int T, int K2,
                       int t0, int k0, int pt) {
  constexpr int kPer = 128 / G;   // granules per row
#pragma unroll 1
  for (int c = pt; c < 2 * BT * kPer; c += kProducers) {
    const int p = c / (BT * kPer), t = c / kPer % BT, b = c % kPer * G;
    const int k = k0 + b / 2;
    const bool ok = t0 + t < T && k < K2;
    const unsigned char* src = ok ? x2 + p * plane + (static_cast<long>(t0 + t) * K2 + k) * 2 : x2;
    copy_granule<G>(dst + p * BT * 128 + swz(t, b), src, ok);
  }
}

// packed rows k0 .. k0 + 63, columns n0 .. n0 + 127 into a swizzled tile
template <int G>
__device__ void copy_w(unsigned char* dst, const unsigned char* packed, int K2, int N, int n0,
                       int k0, int pt) {
  constexpr int kPer = kCols / G;
#pragma unroll 1
  for (int c = pt; c < kBK * kPer; c += kProducers) {
    const int r = c / kPer, b = c % kPer * G;
    const bool ok = k0 + r < K2 && n0 + b < N;
    const unsigned char* src = ok ? packed + static_cast<long>(k0 + r) * N + n0 + b : packed;
    copy_granule<G>(dst + swz(r, b), src, ok);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group n for a count known at run time (n < kMaxStages)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// CTA c takes the units c, c + ctas, ...; unit u is split u % splits of
// the tile u / splits, which is the row block tile / col_tiles and the
// column tile tile % col_tiles (columns inner, splits innermost, so the
// units in flight share their rows of x and a tile's splits run side by
// side).  A split covers kps stages of K (the last split fewer).
template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
w4_matmul_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const unsigned char* __restrict__ x2, const unsigned char* __restrict__ packed,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ counters, int T, int K2, int N,
                 int col_tiles, int splits, int kps, int units, int gx, int gw, int vec) {
  constexpr int kStages = ring_stages(BT);
  constexpr int kLag = kStages - 2;     // stages of copies in flight
  constexpr int kStage = stage_bytes(BT);
  constexpr int kAcc = BT / 2;
  constexpr int kSteps = kBK / 16;      // k16 steps a stage
  static_assert(kLag >= 1 && kLag <= 6, "a stage in flight, cp_async_wait_n's counts");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int last_split;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int kblocks = (K2 + kBK - 1) / kBK;
  // gx / gw == 0: the operand comes by TMA; with both, one thread fills
  // the ring
  const bool tma_only = gx == 0 && gw == 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], tma_only ? 1 : kProducers);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    if (tma_only && pt != 0) return;
    const uint32_t tma_bytes = (gx ? 0 : 2 * BT * 128) + (gw ? 0 : kBK * kCols);
    const long plane = static_cast<long>(T) * K2 * 2;
    int slot = 0, pass = 0, sig = 0, pending = 0;
    // once a stage's copies are done: into the async proxy, then ready
    auto signal = [&]() {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      hopper::mbar_arrive(&full[sig]);
      if (++sig == kStages) sig = 0;
    };
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int s = u % splits, tile = u / splits;
      const int rblk = tile / col_tiles, n0 = (tile - rblk * col_tiles) * kCols;
      const int kb1 = min(s * kps + kps, kblocks);
      for (int kb = s * kps; kb < kb1; ++kb) {
        if (pass > 0) w4s::bar_wait(&empty[slot], (pass - 1) & 1);
        unsigned char* st = ring + slot * kStage;
        const int t0 = rblk * BT, k0 = kb * kBK;
        if (pt == 0 && tma_bytes) {
          uint64_t* bar = &full[slot];
          if (tma_only) {
            hopper::mbar_expect_tx(bar, tma_bytes);   // with thread 0's arrival
          } else {
            asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                             hopper::smem_u32(bar)),
                         "r"(tma_bytes)
                         : "memory");
          }
          if (!gx) hopper::tma_load_3d(st, &tm_x, bar, k0, t0, 0);
          if (!gw) hopper::tma_load_2d(st + 2 * BT * 128, &tm_w, bar, n0, k0);
        }
        if (tma_only) {
          if (++slot == kStages) slot = 0, ++pass;
          continue;
        }
        switch (gx) {
          case 0: break;
          case 16: copy_x<BT, 16>(st, x2, plane, T, K2, t0, k0, pt); break;
          case 8: copy_x<BT, 8>(st, x2, plane, T, K2, t0, k0, pt); break;
          case 4: copy_x<BT, 4>(st, x2, plane, T, K2, t0, k0, pt); break;
          default: copy_x<BT, 2>(st, x2, plane, T, K2, t0, k0, pt); break;
        }
        unsigned char* sw = st + 2 * BT * 128;
        switch (gw) {
          case 0: break;
          case 16: copy_w<16>(sw, packed, K2, N, n0, k0, pt); break;
          case 8: copy_w<8>(sw, packed, K2, N, n0, k0, pt); break;
          case 4: copy_w<4>(sw, packed, K2, N, n0, k0, pt); break;
          case 2: copy_w<2>(sw, packed, K2, N, n0, k0, pt); break;
          default: copy_w<1>(sw, packed, K2, N, n0, k0, pt); break;
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        if (++pending > kLag) {
          cp_async_wait<kLag>();
          signal();
          --pending;
        }
        if (++slot == kStages) slot = 0, ++pass;
      }
    }
    // the last stages as each lands (a unit of fewer stages than the lag
    // would otherwise wait for all of them)
    if (!tma_only) {
      for (; pending > 0; --pending) {
        cp_async_wait_n(pending - 1);
        signal();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int ct = threadIdx.x, wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int lc = wg * 64 + warp * 16 + gid * 2;   // the columns of rows gid, gid + 8
  const uint32_t ring_s = hopper::smem_u32(ring);
  // this lane's bytes of packed rows 2 tig (+ 8) and 2 tig + 1 (+ 9) of a
  // k16 step, in the swizzled weight tile
  const uint32_t w_even = 2 * BT * 128 + swz(2 * tig, lc);
  const uint32_t w_odd = 2 * BT * 128 + swz(2 * tig + 1, lc);
  const int tiles = col_tiles * ((T + BT - 1) / BT);
  const long part_tile = static_cast<long>(kAcc) * kConsumers;   // floats per tile and split
  float acc[kAcc];
  uint32_t a[2][2][4];   // [k16 step & 1][lo, hi][fragment]
  int slot = 0, pass = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = u % splits, tile = u / splits;
    const int rblk = tile / col_tiles, n = (tile - rblk * col_tiles) * kCols + lc;
    const int kb0 = s * kps, kb1 = min(kb0 + kps, kblocks);
    const float s0 = n < N ? scale[n] : 0.0f, s1 = n + 1 < N ? scale[n + 1] : 0.0f;
    int prev = 0;
    for (int kb = kb0; kb < kb1; ++kb) {
      w4s::bar_wait(&full[slot], pass & 1);
      const uint32_t st = ring_s + slot * kStage;
      const uint64_t de = hopper::sw128_desc(ring + slot * kStage);
      const uint64_t dodd = hopper::sw128_desc(ring + slot * kStage + BT * 128);
      // a k16 step's four packed rows, loaded a step ahead of their widening
      uint32_t v[4];
      auto load = [&](int kk) {
        const uint32_t r0 = st + w_even + kk * 16 * 128, r1 = st + w_odd + kk * 16 * 128;
        v[0] = lds_u16(r0);
        v[1] = lds_u16(r1);
        v[2] = lds_u16(r0 + 8 * 128);
        v[3] = lds_u16(r1 + 8 * 128);
      };
      load(0);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        widen(a[kk & 1], v[0], v[1], v[2], v[3]);
        hopper::wgmma_fence();
        wgmma_rs<BT>(acc, a[kk & 1][0], de + 2 * kk, kk > 0 || kb > kb0);
        wgmma_rs<BT>(acc, a[kk & 1][1], dodd + 2 * kk, 1);
        hopper::wgmma_commit();
        if (kk + 1 < kSteps) load(kk + 1);
        hopper::wgmma_wait<1>();   // the step before is done: its fragments and slot are free
        hopper::fence_acc(a[(kk & 1) ^ 1][0]);
        hopper::fence_acc(a[(kk & 1) ^ 1][1]);
        if (kk == 0 && kb > kb0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = slot;
      if (++slot == kStages) slot = 0, ++pass;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    if (splits > 1) {
      // this split's partial into the workspace; the tile's last split to
      // arrive sums them all, in split order
      // (the CTA's barrier, then one thread's acq_rel atomic: the partials
      // of every thread are released with it, and the last split's threads
      // read the others' after the barrier that follows its acquire)
      float* mine = part + (static_cast<long>(s) * tiles + tile) * part_tile + ct;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) __stcg(mine + i * kConsumers, acc[i]);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (ct == 0) {
        int seen;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(seen) : "l"(counters + tile) : "memory");
        last_split = seen == splits - 1;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (!last_split) continue;
      const float* base = part + static_cast<long>(tile) * part_tile + ct;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = __ldcg(base + i * kConsumers);
#pragma unroll 3
      for (int j = 1; j < splits; ++j) {
        const float* pj = base + static_cast<long>(j) * tiles * part_tile;
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], __ldcg(pj + i * kConsumers));
      }
      if (ct == 0) counters[tile] = 0;   // ready for the next call
    }

    // out = bf16(acc * scale): this lane's accumulator element 4 q + e is
    // the token 8 q + 2 tig + e of the unit and column n (row gid), 4 q + 2
    // + e the same token and column n + 1 (row gid + 8)
    const int t0 = rblk * BT + 2 * tig;
#pragma unroll
    for (int q = 0; q < BT / 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + 8 * q + e;
        if (t >= T) continue;
        const __nv_bfloat16 y0 = __float2bfloat16_rn(__fmul_rn(acc[4 * q + e], s0));
        const __nv_bfloat16 y1 = __float2bfloat16_rn(__fmul_rn(acc[4 * q + 2 + e], s1));
        __nv_bfloat16* o = out + static_cast<long>(t) * N + n;
        if (vec && n + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, y1);
        } else {
          if (n < N) o[0] = y0;
          if (n + 1 < N) o[1] = y1;
        }
      }
  }
}

// The largest granule of 16, 8, 4, 2 and 1 bytes that divides both a base
// address and a row pitch: every granule of every row is then aligned.
int granule(const void* base, long pitch) {
  for (int g = 16; g > 1; g /= 2)
    if (reinterpret_cast<uintptr_t>(base) % g == 0 && pitch % g == 0) return g;
  return 1;
}

template <int BT>
int launch(const void* x2, const void* packed, const void* scale, void* out, void* part,
           void* counters, int T, int K2, int N, int col_tiles, int splits, int kps, int units,
           int ctas, cudaStream_t st) {
  static int allowed = 0;
  const int err = hopper::allow_smem(w4_matmul_kernel<BT>, ring_smem(BT), allowed);
  if (err) return err;
  const int vec = N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  // TMA where the pitches and bases allow it (granule 0 tells the kernel);
  // a map that cuTensorMapEncodeTiled refuses leaves the operand to cp.async
  CUtensorMap tm_x{}, tm_w{};
  int gx = granule(x2, 2L * K2), gw = granule(packed, N);
  if (gx == 16) {   // x2 as [2][T][K2] bf16: a box is both planes' BT rows of 64 columns
    const cuuint64_t d[3] = {static_cast<cuuint64_t>(K2), static_cast<cuuint64_t>(T), 2};
    const cuuint64_t pitch[2] = {2ull * K2, 2ull * K2 * T};
    const cuuint32_t box[3] = {kBK, BT, 2};
    if (hopper::encode_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x2, d, pitch, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      gx = 0;
  }
  if (gw == 16) {   // packed [K2][N] bytes: a box is kBK rows of 128 columns
    const cuuint64_t d[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K2)};
    const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(N)};
    const cuuint32_t box[2] = {kCols, kBK};
    if (hopper::encode_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, d, pitch, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      gw = 0;
  }
  w4_matmul_kernel<BT><<<ctas, kThreads, ring_smem(BT), st>>>(
      tm_x, tm_w, static_cast<const unsigned char*>(x2), static_cast<const unsigned char*>(packed),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), T, K2, N, col_tiles, splits, kps,
      units, gx, gw, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x2 [2, T, K2] bf16, packed [K2, N] int8, scale [N] f32, out [T, N] bf16,
// all contiguous.  The plan (ops/w4_matmul.py::plan): bt rows per unit,
// row_blocks and col_tiles units along T and N, K cut into splits of kps
// stages, the persistent CTAs and the dynamic shared bytes; a plan that
// does not match these constants is refused.  With more than one split,
// part holds splits x tiles x bt x 128 f32 partials and counters one int
// per tile (row_blocks x col_tiles), zero before the call and after it.
// Returns a cudaError_t.
extern "C" int lavida_w4_matmul(const void* x2, const void* packed, const void* scale, void* out,
                                void* part, void* counters, int T, int K2, int N, int bt,
                                int row_blocks, int col_tiles, int splits, int kps, int ctas,
                                int smem, void* stream) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || K2 <= 0 || N <= 0) return kBad;
  int want = T <= 8 ? 8 : T <= 16 ? 16 : T <= 32 ? 32 : 64;   // the decode plan's rows
  if (T > kDecMaxRows) want = bt == 128 || bt == 256 ? bt : 0;
  const int kblocks = (K2 + kBK - 1) / kBK;
  if (bt != want || row_blocks != (T + bt - 1) / bt || col_tiles != (N + kCols - 1) / kCols ||
      splits < 1 || splits > kMaxSplits || kps < 1 || (splits - 1) * kps >= kblocks ||
      splits * kps < kblocks || ctas < 1 || ctas > row_blocks * col_tiles * splits ||
      smem != ring_smem(bt) || (splits > 1 && (part == nullptr || counters == nullptr)))
    return kBad;
  const int units = row_blocks * col_tiles * splits;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 8:
      return launch<8>(x2, packed, scale, out, part, counters, T, K2, N, col_tiles, splits, kps,
                       units, ctas, st);
    case 16:
      return launch<16>(x2, packed, scale, out, part, counters, T, K2, N, col_tiles, splits, kps,
                        units, ctas, st);
    case 32:
      return launch<32>(x2, packed, scale, out, part, counters, T, K2, N, col_tiles, splits, kps,
                        units, ctas, st);
    case 64:
      return launch<64>(x2, packed, scale, out, part, counters, T, K2, N, col_tiles, splits, kps,
                        units, ctas, st);
    case 128:
      return launch<128>(x2, packed, scale, out, part, counters, T, K2, N, col_tiles, splits, kps,
                         units, ctas, st);
    default:
      return launch<256>(x2, packed, scale, out, part, counters, T, K2, N, col_tiles, splits, kps,
                         units, ctas, st);
  }
}
