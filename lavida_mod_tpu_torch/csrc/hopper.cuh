// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels
// (short_attention.cu, prefix_flash.cu, w8a8_matmul.cu, w4_fused.cu,
// w4_grouped.cu, vit_mlp.cu): shared-memory addresses, mbarriers, TMA tile
// loads, the wgmma fence / commit / wait, the swizzled K-major descriptor
// and the bf16 product with both operands in shared memory, launches
// under programmatic dependent launch, and the host-side encoding of TMA
// tensor maps, cached by their arguments.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, counted on `bar` as transaction
// bytes: no tensor map, one instruction per copy.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Programmatic dependent launch: `griddep_launch_dependents` lets the next
// kernel of the stream, launched with programmatic stream serialization,
// start once every CTA of this one has issued it; `griddep_wait` blocks
// until the kernel before this one has completed and its writes are
// visible.  Both are no-ops for a kernel launched without the attribute.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in 128-byte-swizzled
// rows: 8-row core groups 1024 bytes apart (the stride byte offset).  A
// step of 32 bytes along K inside the swizzled row adds 2 to it.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Registers that an asynchronous product writes (accumulators) or still
// reads (A fragments): the compiler must neither move their uses across
// the wait nor give their registers to other values until then.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, f32) (+)= A (64 x 16, K-major smem) * B (16 x N, K-major
// smem); scale_d = 0 overwrites D.  One specialization per N.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
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

// Launch with programmatic stream serialization: the kernel may start
// while the one before it runs, and waits for it with griddepcontrol.wait.
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, int smem,
                     cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...));
}

// Raise the kernel's dynamic shared-memory cap to `smem` if it is lower.
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, int& allowed) {
  if (smem <= allowed) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed = smem;
  return 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (nothing links against libcuda); null if the driver does not have it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

struct MapKey {
  uint64_t v[14];
  bool operator==(const MapKey& o) const { return memcmp(v, o.v, sizeof v) == 0; }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = 1469598103934665603ull;  // FNV-1a over the words
    for (uint64_t x : k.v) h = (h ^ x) * 1099511628211ull;
    return static_cast<size_t>(h);
  }
};

// A tiled tensor map of `rank` (<= 4) dimensions, innermost first, with
// byte strides of the outer rank - 1, elements of 1 x ... x 1, L2 promotion
// 256 B and zero fill past the bounds.  A map is a pure function of these
// arguments (it holds the address, not the data), so one encoded before for
// the same arguments is reused: the serving paths call with the same few
// buffers, and an encode costs the host microseconds per map.  Returns
// false if the driver refuses the map.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  if (rank < 1 || rank > 4) return false;
  MapKey key{};
  key.v[0] = static_cast<uint64_t>(type) | static_cast<uint64_t>(rank) << 8 |
             static_cast<uint64_t>(swizzle) << 16;
  key.v[1] = reinterpret_cast<uint64_t>(base);
  for (int i = 0; i < rank; ++i) {
    key.v[2 + i] = dims[i];
    key.v[6 + i] = box[i];
    if (i + 1 < rank) key.v[10 + i] = strides[i];
  }
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) {
      *map = it->second;
      return true;
    }
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  std::lock_guard<std::mutex> lock(mu);
  if (cache.size() >= 4096) cache.clear();  // bounded: old buffers' maps go
  cache.emplace(key, *map);
  return true;
}

}  // namespace hopper
