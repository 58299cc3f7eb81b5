// Row gather out[t] = table[idx[t]], for Hopper (sm_90a).
//
// Replaces: lavida_mod_tpu/ops/pallas_gather.py::gather_rows (the Pallas
// TPU kernel that streams the multimodal splice, `table[gather_idx]`, with
// the indices in scalar prefetch and one row DMA per grid step).
//
// What bounds it on the H100: pure data movement.  The slice's splice reads
// and writes T = 1056 rows of D = 4096 bf16 (8 KB each), about 17 MB in
// all, so it is bound by device-memory bandwidth and, at this size, by the
// launch itself.
//
// What the design does about it: one CTA per output row; its threads copy
// the row with the widest vector that divides the row's byte width (16-byte
// uint4 for D = 4096 bf16, 512 vectors per row), neighbouring threads on
// neighbouring addresses.  A row whose byte width is not a multiple of 16
// goes in 8-, 4- or 2-byte units, so any D works.  Each CTA reads its own
// index (the TPU kernel's scalar prefetch has no counterpart to keep).  The
// wrapper range-checks the host copy of the plan before upload, so the
// kernel does no bounds test of its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename Vec, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ table, const Index* __restrict__ idx,
                   Vec* __restrict__ out, long vecs_per_row) {
  const long t = blockIdx.x;
  const Vec* src = table + static_cast<long>(idx[t]) * vecs_per_row;
  Vec* dst = out + t * vecs_per_row;
  for (long i = threadIdx.x; i < vecs_per_row; i += kThreads) {
    dst[i] = src[i];
  }
}

template <typename Index>
int launch(const void* table, const void* idx, void* out, long T, long row_bytes,
           cudaStream_t stream) {
  const auto* ix = static_cast<const Index*>(idx);
  const dim3 grid(static_cast<unsigned>(T));
  if (row_bytes % 16 == 0) {
    gather_rows_kernel<uint4, Index><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(table), ix, static_cast<uint4*>(out), row_bytes / 16);
  } else if (row_bytes % 8 == 0) {
    gather_rows_kernel<uint2, Index><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint2*>(table), ix, static_cast<uint2*>(out), row_bytes / 8);
  } else if (row_bytes % 4 == 0) {
    gather_rows_kernel<uint32_t, Index><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out), row_bytes / 4);
  } else if (row_bytes % 2 == 0) {
    gather_rows_kernel<uint16_t, Index><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(table), ix, static_cast<uint16_t*>(out), row_bytes / 2);
  } else {
    gather_rows_kernel<uint8_t, Index><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(table), ix, static_cast<uint8_t*>(out), row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [N, row_bytes] and out [T, row_bytes], both 16-byte aligned and
// contiguous; idx [T] of int32 (index_bytes 4) or int64 (8), every entry in
// [0, N).  Returns a cudaError_t.
extern "C" int lavida_gather_rows(const void* table, const void* idx, int index_bytes,
                                  void* out, long T, long row_bytes, void* stream) {
  if (T <= 0 || row_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (index_bytes == 4) return launch<int32_t>(table, idx, out, T, row_bytes, st);
  if (index_bytes == 8) return launch<int64_t>(table, idx, out, T, row_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
