"""W8A8 matmul: the port of lavida_mod_tpu/ops/pallas_w8.py (kernel #3,
`w8a8_matmul`, and its drop-in `linear_w8a8`), the int8 prefill's linear.

`w8a8_matmul(x8, sx, w8, scale)` computes `(x8 @ w8^T)` in int32, then
`(f32(acc) * sx) * scale` rounded to bf16, with x8 [T, K] int8, sx [T, 1]
f32, w8 [N, K] int8 (the port's K-major layout of the JAX [K, N]
`kernel_q`) and scale [N] f32.  CUDA tensors launch the hand-written
tensor-core GEMM of csrc/w8a8_matmul.cu; CPU tensors run
`w8a8_matmul_reference`.  The int32 sum is exact in both (127^2 * K <
2^31 for K < 133,000) and the epilogue rounds in the same order, so the two
are bit-equal.

The per-token activation quantization stays a separate pass, as on the TPU
(pallas_w8.py:21-23): `quantize_act_int8` in torch on the CPU, the
row-quantization kernel of csrc/w4_fused.cu on the card.
"""

from __future__ import annotations

import torch

from .. import kernels
from .quant import int_matmul, quantize_act_int8, quantize_act_w4

ACT_FORMULA_W8 = 0   # sx = max(amax / 127, 1e-8)   (pallas_w8.py:45)
ACT_FORMULA_W4 = 1   # sx = max(amax, 1e-8) / 127   (w4_fused.py:72-73)
# sx = max(amax, 1e-8) * f32(1/127): pallas_w4.py:172 as XLA compiles it
# (quant.quantize_act_w4(reciprocal=True))
ACT_FORMULA_W4_RECIP = 2


def w8a8_matmul_reference(x8: torch.Tensor, sx: torch.Tensor,
                          w8: torch.Tensor, scale: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: exact integer product, then the epilogue."""
    acc = int_matmul(x8, w8).float()
    return (acc * sx.float() * scale.float()).to(torch.bfloat16)


def _check(x8, sx, w8, scale):
    T, K = x8.shape
    N = w8.shape[0]
    want = {"x8": (x8, torch.int8, (T, K)), "sx": (sx, torch.float32, (T, 1)),
            "w8": (w8, torch.int8, (N, K)),
            "scale": (scale, torch.float32, (N,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x8.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"w8a8_matmul: {name} must be contiguous "
                             f"{dtype} {shape} on {x8.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if K % 16 or T < 1 or N < 1 or x8.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError(f"w8a8_matmul: K={K} must be a multiple of 16 and "
                         f"the operands 16-byte aligned")


def w8a8_matmul(x8: torch.Tensor, sx: torch.Tensor, w8: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """(x8 @ w8^T) * sx * scale -> [T, N] bf16 (see the module note)."""
    if not x8.is_cuda:
        return w8a8_matmul_reference(x8, sx, w8, scale)
    _check(x8, sx, w8, scale)
    T, K = x8.shape
    N = w8.shape[0]
    out = torch.empty(T, N, dtype=torch.bfloat16, device=x8.device)
    kernels.check(kernels.library().lavida_w8a8_matmul(
        x8.data_ptr(), sx.data_ptr(), w8.data_ptr(), scale.data_ptr(),
        out.data_ptr(), T, K, N,
        torch.cuda.current_stream(x8.device).cuda_stream), "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def act_quant(x: torch.Tensor, formula: int):
    """Per-token int8 of x [T, K] by one of the three formulas: the row
    kernel on the card (bf16 x), torch on the CPU.  Returns (x8, sx)."""
    if not x.is_cuda:
        return (quantize_act_int8(x) if formula == ACT_FORMULA_W8
                else quantize_act_w4(x, formula == ACT_FORMULA_W4_RECIP))
    T, K = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or K % 8 \
            or x.data_ptr() % 16:
        raise ValueError(f"act_quant: x must be contiguous 16-byte aligned "
                         f"bf16 [T, K] with K % 8 == 0; got {x.dtype} "
                         f"{tuple(x.shape)}")
    x8 = torch.empty(T, K, dtype=torch.int8, device=x.device)
    sx = torch.empty(T, 1, dtype=torch.float32, device=x.device)
    kernels.check(kernels.library().lavida_act_quant(
        x.data_ptr(), x8.data_ptr(), sx.data_ptr(), T, K, formula,
        torch.cuda.current_stream(x.device).cuda_stream), "act_quant")
    return x8, sx


def linear_w8a8(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                preferred=None) -> torch.Tensor:
    """`linear_act_int8` on an int8 linear (pallas_w8.py:216-237 /
    quant.py:195-230): per-token A8 codes, the W8A8 matmul, the result in
    `preferred` or x's dtype.  On the CPU the bf16 rounding of the kernel's
    epilogue is kept, so a bf16 model computes what the TPU kernel and
    the JAX CPU fallback both compute."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        x2d = x2d.contiguous()
    x8, sx = act_quant(x2d, ACT_FORMULA_W8)
    y = w8a8_matmul(x8, sx, w8, scale)
    return y.reshape(*lead, y.shape[-1]).to(preferred or x.dtype)
