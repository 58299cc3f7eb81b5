"""The fused SigLIP MLP half-block: the port of lavida_mod_tpu/ops/vit_mlp.py
(kernel #9, `fused_vit_mlp`), x + fc2(gelu_tanh(fc1(LN(x)) + b1)) + b2.

The weights come in the nn.Linear layouts: w1 [F, D] (fc1.weight), w2
[D, F] (fc2.weight).  CUDA tensors launch the three kernels of
csrc/vit_mlp.cu (bf16 throughout: a LayerNorm pass and one wgmma GEMM
with an fc1 and an fc2 epilogue, under programmatic dependent launch);
CPU tensors run the plain version, which follows the TPU kernel's f32
order (vit_mlp.py:37-59): LN in f32 rounded to x's dtype; per 512-wide F
tile, fc1 in f32, + b1 and the tanh GELU in f32, rounded to x's dtype, its
fc2 product in f32 added to the accumulator tile by tile in order; the
epilogue x + acc + b2 in f32, then x's dtype.  The zero-padded F and M
edges of the TPU kernel are exact, so both versions simply stop at F and
M.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

TILE_F = 512


def _gelu_tanh_f32(v: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) in f32."""
    inner = math.sqrt(2 / math.pi) * (v + 0.044715 * (v * v * v))
    return v * (0.5 * (1.0 + torch.tanh(inner)))


def fused_vit_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps=1e-6):
    """Plain version: x [..., D] -> [..., D] in x's dtype."""
    shape, dt = x.shape, x.dtype
    xf = x.reshape(-1, shape[-1]).float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
          + beta.float()).to(dt).float()
    acc = torch.zeros_like(xf)
    F = w1.shape[0]
    for f0 in range(0, F, TILE_F):
        sl = slice(f0, min(F, f0 + TILE_F))
        h = ln @ w1[sl].float().t() + b1[sl].float()
        h = _gelu_tanh_f32(h).to(dt).float()
        acc = acc + h @ w2[:, sl].float().t()
    return (xf + acc + b2.float()).to(dt).reshape(shape)


def fused_vit_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6):
    """x [..., D] -> x + fc2(gelu_tanh(fc1(LN(x)) + b1)) + b2."""
    if not x.is_cuda:
        return fused_vit_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps)
    D = x.shape[-1]
    F = w1.shape[0]
    want = {"gamma": (gamma, (D,)), "beta": (beta, (D,)), "w1": (w1, (F, D)),
            "b1": (b1, (F,)), "w2": (w2, (D, F)), "b2": (b2, (D,))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != x.device \
                or t.data_ptr() % 16:
            raise ValueError(f"fused_vit_mlp: {name} must be contiguous bf16 "
                             f"{shape} at a 16-byte aligned address; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.dtype != torch.bfloat16 or D % 8 or F % 8:
        raise ValueError(f"fused_vit_mlp: x {x.dtype} {tuple(x.shape)}, "
                         f"F = {F}: bf16 with D and F multiples of 8")
    x2 = x.reshape(-1, D).contiguous()
    if x2.data_ptr() % 16:      # the kernels read rows in 16-byte pieces
        x2 = x2.clone()
    M = x2.shape[0]
    ln = torch.empty_like(x2)
    h = torch.empty(M, F, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x2)
    kernels.check(kernels.library().lavida_vit_mlp(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln.data_ptr(),
        h.data_ptr(), out.data_ptr(), M, D, F, eps,
        torch.cuda.current_stream(x.device).cuda_stream), "fused_vit_mlp")
    fused_vit_mlp.launches += 1
    return out.view(x.shape)


fused_vit_mlp.launches = 0
