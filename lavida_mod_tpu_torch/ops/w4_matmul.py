"""Per-channel int4 weight matmul: the port of lavida_mod_tpu/ops/
pallas_w4.py's `w4_matmul` (kernel #11), at its public layout.

`w4_matmul(x2, packed, scale)`: x2 [2, T, K/2] bf16 is `split_even_odd`
of x [T, K] (the even and the odd K columns), packed [K/2, N] int8 is
`quant.pack_w4` of the int4 codes (row 2k in the low nibble of byte k,
row 2k + 1 in the high one, both signed), scale [N] f32 is per output
channel.  The result is bf16((x_even @ lo + x_odd @ hi) * scale), the dots
taken in f32 over the exactly converted nibbles (pallas_w4.py:64-77).
CUDA tensors launch csrc/w4_matmul.cu; CPU tensors run
`w4_matmul_reference`, which computes in the TPU kernel's order: the two
f32 products, their sum, the scale, then bf16.  The kernel sums the two
products' terms in one accumulator, in another order, so the two agree
within one bf16 rounding (tests/test_torch_w4_matmul.py).

No model leaf or serving path builds this layout in either package (the
int4 serving layouts are grouped, ops/w4_grouped.py); the JAX package
exercises the kernel in tests/test_pallas_w4.py, and the port holds it
the same way.
"""

from __future__ import annotations

import torch

from .. import kernels


def split_even_odd(x: torch.Tensor) -> torch.Tensor:
    """pallas_w4.py:42-45: [T, K] -> [2, T, K/2] (even K columns, odd K
    columns)."""
    return torch.stack([x[:, 0::2], x[:, 1::2]], dim=0).contiguous()


def unpack_nibbles(packed: torch.Tensor):
    """int8 [K/2, N] -> (lo, hi) int32 codes in [-8, 7]: the low nibble of
    each byte and the high one, both sign-extended (pallas_w4.py:65-69)."""
    p = packed.to(torch.int32)
    return (p << 28) >> 28, p >> 4


def w4_matmul_reference(x2: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 `x_even @ lo`, plus f32 `x_odd @ hi`, times the
    per-channel scale, rounded to bf16 [T, N]."""
    lo, hi = unpack_nibbles(packed)
    acc = x2[0].float() @ lo.float()
    acc = acc + x2[1].float() @ hi.float()
    return (acc * scale.float()).to(torch.bfloat16)


def _check(x2, packed, scale):
    if x2.dim() != 3 or x2.shape[0] != 2 or x2.dtype != torch.bfloat16 \
            or not x2.is_contiguous():
        raise ValueError(f"w4_matmul: x2 must be contiguous bf16 [2, T, K/2];"
                         f" got {x2.dtype} {tuple(x2.shape)}")
    K2 = x2.shape[2]
    if packed.dim() != 2 or packed.shape[0] != K2 \
            or packed.dtype != torch.int8 or not packed.is_contiguous():
        raise ValueError(f"w4_matmul: packed must be contiguous int8 "
                         f"[{K2}, N]; got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    N = packed.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,) \
            or not scale.is_contiguous():
        raise ValueError(f"w4_matmul: scale must be contiguous f32 [{N}]; "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"w4_matmul: {name} on {t.device}, x2 on "
                             f"{x2.device}")
    if min(x2.shape[1], K2, N) < 1:
        raise ValueError(f"w4_matmul: empty operand {tuple(x2.shape)} x "
                         f"{tuple(packed.shape)}")


def w4_matmul(x2: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """(x @ unpack(packed)) * scale -> [T, N] bf16 (see the module note)."""
    if not x2.is_cuda:
        return w4_matmul_reference(x2, packed, scale)
    _check(x2, packed, scale)
    _, T, K2 = x2.shape
    N = packed.shape[1]
    out = torch.empty(T, N, dtype=torch.bfloat16, device=x2.device)
    kernels.check(kernels.library().lavida_w4_matmul(
        x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        T, K2, N, torch.cuda.current_stream(x2.device).cuda_stream),
        "w4_matmul")
    w4_matmul.launches += 1
    return out


w4_matmul.launches = 0
