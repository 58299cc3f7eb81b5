"""Grouped int4 W4A8 matmul: the port of lavida_mod_tpu/ops/pallas_w4.py
(kernel #4, `w4_matmul_grouped`), every LM linear of the unfused int4
serving layout.

`w4_matmul_grouped(x, packed, scales)`: x [T, K] bf16 is quantized per
token (`sx = max(amax, 1e-8) / 127`, pallas_w4.py:170-173, which XLA
compiles into `max(amax, 1e-8) * f32(1/127)`, so the port computes that:
`quant.quantize_act_w4(reciprocal=True)`), the codes are
multiplied with the grouped int4 weights (fragment layout of ops/quant.py,
scales [K/128, N] f32) and the result is bf16 [T, N].  CUDA tensors run the
row quantization kernel of csrc/w4_fused.cu and the GEMM of
csrc/w4_grouped.cu; CPU tensors run `w4_matmul_grouped_reference`, which
follows the TPU kernel's f32 order: inside each k-block of `gb` groups a
partial sum starts at 0 and takes `part + d_g * s_g` group by group, the
partial is added to the accumulator, and the epilogue is bf16(acc * sx)
(pallas_w4.py:212-235).  The two are bit-equal; the plain version is
bit-equal to the Pallas kernel in interpret mode too
(tests/test_torch_w4_grouped.py).

The JAX model off the TPU takes `_linear_w4`'s einsum fallback instead,
which applies the group scales in one contraction; the port's CPU model
path keeps that one (`quant.linear_w4_reference`).
"""

from __future__ import annotations

import torch

from .. import kernels
from .quant import GROUP, quantize_act_w4, unpack_w4
from .w8a8 import ACT_FORMULA_W4_RECIP, act_quant


def groups_per_kblock(K: int) -> int:
    """pallas_w4.py:194-195: the k-block is the largest of 2048 / 1024 /
    ... / 64 packed rows dividing K/2 (a multiple of the 64-row half
    group); in groups of 128."""
    K2 = K // 2
    block_k = next(b for b in (2048, 1024, 512, 256, 128, 64)
                   if K2 % b == 0 and b % (GROUP // 2) == 0)
    return block_k // (GROUP // 2)


def w4_matmul_grouped_reference(x: torch.Tensor, packed: torch.Tensor,
                                scales: torch.Tensor) -> torch.Tensor:
    """Plain version: x [T, K] -> [T, N] bf16 in the TPU kernel's order.
    Each group's dot is exact (computed in f64 group by group, so memory
    stays at one [T, N] block)."""
    x8, sx = quantize_act_w4(x.to(torch.bfloat16), reciprocal=True)
    w = unpack_w4(packed).to(x8.device)
    K, N = w.shape
    gb = groups_per_kblock(K)
    xd = x8.double()
    acc = torch.zeros(x8.shape[0], N, dtype=torch.float32, device=x8.device)
    for k0 in range(0, K // GROUP, gb):
        part = torch.zeros_like(acc)
        for g in range(k0, k0 + gb):
            sl = slice(g * GROUP, (g + 1) * GROUP)
            d = (xd[:, sl] @ w[sl].double()).float()
            part = part + d * scales[g]
        acc = acc + part
    return (acc * sx).to(torch.bfloat16)


def w4_matmul_grouped(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """x [T, K] bf16 @ grouped int4 W [K, N] -> [T, N] bf16 (N the padded
    width of `packed`; the caller trims)."""
    if not x.is_cuda:
        return w4_matmul_grouped_reference(x, packed, scales)
    K = packed.shape[1] * GROUP
    N = packed.shape[0] * 8
    T = x.shape[0]
    if x.dim() != 2 or x.shape[1] != K or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError(f"w4_matmul_grouped: x must be contiguous bf16 "
                         f"[T, {K}]; got {x.dtype} {tuple(x.shape)}")
    if packed.dtype != torch.uint8 or packed.shape[2] != 512 \
            or not packed.is_contiguous() or packed.device != x.device:
        raise ValueError("w4_matmul_grouped: packed must be the contiguous "
                         "fragment layout [N/8, K/128, 512] on x's device")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (K // GROUP, N) \
            or not scales.is_contiguous() or scales.device != x.device:
        raise ValueError(f"w4_matmul_grouped: scales must be contiguous f32 "
                         f"[{K // GROUP}, {N}]; got {tuple(scales.shape)}")
    if N % 64 or T < 1:
        raise ValueError(f"w4_matmul_grouped: N = {N} must be a multiple "
                         f"of 64")
    x8, sx = act_quant(x, ACT_FORMULA_W4_RECIP)
    out = torch.empty(T, N, dtype=torch.bfloat16, device=x.device)
    kernels.check(kernels.library().lavida_w4_grouped(
        x8.data_ptr(), sx.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        out.data_ptr(), T, K, N, groups_per_kblock(K),
        torch.cuda.current_stream(x.device).cuda_stream), "w4_matmul_grouped")
    w4_matmul_grouped.launches += 1
    return out


w4_matmul_grouped.launches = 0
