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
// of FlashAttention-3): the pipeline of csrc/flash_attention.cuh, shared
// with kernel #10's forward (prefix_flash.cu): a producer warpgroup keeps a
// three-stage TMA ring of 128-key K/V tiles (with the tile's key segment
// ids) in flight, two consumer warpgroups of 64 query rows each issue
// wgmma for S = Q K^T and, with p from registers, for O += P V, S_j together
// with P_{j-1} V_{j-1}, and hand the tensor cores back and forth on named
// barriers; the producer gives its registers away with `setmaxnreg`.  A
// narrow tail box keeps hd = 72 from copying 56 columns of zero fill.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using namespace flash;

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
  flash_fwd<HDP, false>(&tm_q, &tm_k, &tm_v, &tt_q, &tt_k, &tt_v, q_seg, kv_seg, out, nullptr, T, S,
                        Hq, Hkv, hd, scale_log2);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const int32_t* q_seg,
           const int32_t* kv_seg, void* out, int B, int T, int S, int Hq, int Hkv, int hd,
           float scale, cudaStream_t stream) {
  static_assert(kBM == 128 && kBN == 128, "the tensor maps' boxes are 128 rows");
  constexpr int smem = (1 + 2 * kStages) * Layout<HDP>::kTile + 1024;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(short_attention_kernel<HDP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap maps[6];  // q, k, v: 64-column boxes, then tail boxes
  const void* base[3] = {q, k, v};
  const int rows[3] = {T, S, S}, heads[3] = {Hq, Hkv, Hkv};
  for (int i = 0; i < 3; ++i) {
    if (!encode_tile_maps<HDP>(&maps[i], &maps[3 + i], base[i], B, rows[i], heads[i], hd)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((T + kBM - 1) / kBM, Hq, B);
  short_attention_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), T, S, Hq, Hkv, hd, scale * kLog2e);
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
