"""Quantized linears: the port of lavida_mod_tpu/ops/quant.py and the host
quantizers of lavida_mod_tpu/ops/pallas_w4.py.

Two weight layouts, as in the JAX package:
  - int8 per output channel (`quantize_linear`, quant.py:20-33):
    `scale = max(amax / 127, 1e-8)`, codes `clip(round(w / scale))`.
    The port keeps the codes as [N, K] (the nn.Linear layout; the JAX
    `kernel_q` is [K, N]), so both operands of the int8 GEMM are K-major.
  - grouped int4 (`quantize_linear4`, quant.py:36-75; group 128 along K):
    `scale = max(amax / 7, 1e-8)` per (group, column), codes in [-7, 7],
    K zero-padded by `padded_in_dim`, N zero-padded to a multiple of 512
    (the JAX `__trim_N__` key becomes `Int4Linear.out_features`).

The int4 codes are stored in the port's "fragment" layout, read directly
by csrc/w4_fused.cu: a uint8 tensor [N/8, K/128, 512].  The 512 bytes of
(column tile nt, group g) are 32 lanes x 16 bytes; byte j of 32-bit word s
of lane L holds, for column n = 8 nt + L // 4 and
k = 128 g + 32 s + 4 (L % 4) + j, the code of row k in its low nibble and
of row k + 16 in its high nibble.  That is the B operand of
`mma.m16n8k32.s8` for k-step s, so one 16-byte load per lane feeds a
whole group.  `w4_from_jax_packed` maps the JAX `pack_w4` bytes ([K/2, N],
row 2k in the low nibble, 2k+1 in the high one) to it and `unpack_w4`
back to the codes; tests/test_torch_quant.py holds both exact.

Every quantizer exists twice: in numpy, bit-exact with the JAX package's
host code, and in torch, which runs on the card so 8B of bf16 weights are
quantized where they lie.  Divisions by a constant divide by a tensor:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which is not the IEEE quotient numpy and XLA compute.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

GROUP = 128          # int4 scale group along K (quantize_params' default)
N_PAD = 512          # int4 out-dim pad (quantize_linear4)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as an IEEE quotient on every device (see the module note)."""
    return a / torch.full_like(a, c)


# ---------------------------------------------------------------------------
# numpy twins of the JAX host quantizers
# ---------------------------------------------------------------------------

def padded_in_dim(K: int) -> int:
    """pallas_w4.py:97-110: K < 8192 or a multiple of 4096 stays; else the
    next multiple of 4096 (zero rows are exact)."""
    if K < 8192 or K % 4096 == 0:
        return K
    return -(-K // 4096) * 4096


def pack_w4(w: np.ndarray) -> np.ndarray:
    """pallas_w4.py:34-39: [K, N] ints in [-8, 7] -> int8 [K/2, N], row 2k
    in the low nibble and 2k+1 in the high nibble."""
    assert w.shape[0] % 2 == 0
    lo = w[0::2].astype(np.int32) & 0xF
    hi = w[1::2].astype(np.int32) & 0xF
    return ((hi << 4) | lo).astype(np.uint8).view(np.int8)


def quantize_w4_grouped(w: np.ndarray, group: int = GROUP):
    """pallas_w4.py:113-124: [K, N] float -> (packed int8 [K/2, N],
    scales f32 [K/group, N])."""
    K, N = w.shape
    assert K % group == 0 and group % 2 == 0
    wg = w.reshape(K // group, group, N).astype(np.float32)
    scales = np.maximum(np.abs(wg).max(axis=1) / 7.0, 1e-8)
    q = np.clip(np.round(wg / scales[:, None, :]), -7, 7).astype(np.int32)
    return pack_w4(q.reshape(K, N)), scales.astype(np.float32)


def quantize_linear_np(kernel: np.ndarray):
    """quant.py:20-33 on one [K, N] kernel: (codes int8 [K, N], scale f32
    [N])."""
    w = np.asarray(kernel, np.float32)
    amax = np.abs(w).max(axis=-2, keepdims=True)
    scale = np.maximum(amax / np.float32(127.0), np.float32(1e-8))
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.squeeze(-2).astype(np.float32)


def quantize_linear4_np(kernel: np.ndarray, group: int = GROUP):
    """quant.py:36-75 on one [K, N] kernel: (packed int8 [Kp/2, Np],
    scales f32 [Kp/group, Np], N) with the K and N zero pads."""
    kn = np.asarray(kernel, np.float32)
    K, N = kn.shape
    Kp, Np = padded_in_dim(K), -(-N // N_PAD) * N_PAD
    kn = np.pad(kn, ((0, Kp - K), (0, Np - N)))
    packed, scales = quantize_w4_grouped(kn, group)
    return packed, scales, N


# ---------------------------------------------------------------------------
# the fragment layout
# ---------------------------------------------------------------------------

def _frag_view(codes: torch.Tensor) -> torch.Tensor:
    """[K, N] -> [G, s 4, half 2, tig 4, j 4, nt, gid 8] (see module note)."""
    K, N = codes.shape
    return codes.reshape(K // GROUP, 4, 2, 4, 4, N // 8, 8)


def pack_w4_frag(codes: torch.Tensor) -> torch.Tensor:
    """int4 codes [K, N] (int8 in [-8, 7]) -> fragment layout uint8
    [N/8, K/128, 512]."""
    K, N = codes.shape
    if K % GROUP or N % 8:
        raise ValueError(f"pack_w4_frag: [{K}, {N}] needs K % {GROUP} == 0 "
                         f"and N % 8 == 0")
    v = _frag_view(codes.to(torch.int32) & 0xF)
    byte = v[:, :, 0] | (v[:, :, 1] << 4)          # [G, s, tig, j, nt, gid]
    byte = byte.permute(4, 0, 5, 2, 1, 3)          # [nt, G, gid, tig, s, j]
    return byte.to(torch.uint8).reshape(N // 8, K // GROUP, 512).contiguous()


def unpack_w4(packed: torch.Tensor) -> torch.Tensor:
    """Fragment layout [N/8, K/128, 512] -> int4 codes int8 [K, N]."""
    n8, G, _ = packed.shape
    b = packed.view(torch.uint8).to(torch.int32).reshape(n8, G, 8, 4, 4, 4)
    lo = ((b & 0xF) ^ 8) - 8                      # [nt, G, gid, tig, s, j]
    hi = ((b >> 4) ^ 8) - 8
    v = torch.stack([lo, hi], dim=0)              # [half, nt, G, gid, tig, s, j]
    v = v.permute(2, 5, 0, 4, 6, 1, 3)            # [G, s, half, tig, j, nt, gid]
    return v.reshape(G * GROUP, n8 * 8).to(torch.int8)


def unpack_w4_jax(packed: np.ndarray) -> np.ndarray:
    """JAX `pack_w4` bytes [K/2, N] -> codes int8 [K, N] (quant.py:145-149:
    the low nibble sign-extended by a 28-bit shift round trip, the high one
    by an arithmetic shift of the sign-extended byte)."""
    q = np.asarray(packed).view(np.int8).astype(np.int32)
    lo = (q << 28) >> 28
    hi = q >> 4
    return np.stack([lo, hi], axis=1).reshape(2 * q.shape[0], -1).astype(
        np.int8)


def w4_from_jax_packed(packed: np.ndarray) -> torch.Tensor:
    """JAX `kernel_p4` [K/2, N] -> the fragment layout."""
    return pack_w4_frag(torch.from_numpy(unpack_w4_jax(packed)))


# ---------------------------------------------------------------------------
# torch quantizers (run where the weight lies, e.g. on the card)
# ---------------------------------------------------------------------------

@torch.no_grad()
def quantize_linear(weight: torch.Tensor):
    """int8 per-out-channel codes of an nn.Linear weight [N, K]: (codes
    int8 [N, K], scale f32 [N]), bit-exact with `quantize_linear_np`."""
    w = weight.float()
    amax = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(_div(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


@torch.no_grad()
def quantize_linear4(weight: torch.Tensor):
    """Grouped int4 of an nn.Linear weight [N, K]: (fragment-layout packed
    [Np/8, Kp/128, 512], scales f32 [Kp/128, Np], N), the codes and scales
    bit-exact with `quantize_linear4_np` of the [K, N] kernel."""
    N, K = weight.shape
    Kp, Np = padded_in_dim(K), -(-N // N_PAD) * N_PAD
    w = torch.nn.functional.pad(weight.float().t(), (0, Np - N, 0, Kp - K))
    wg = w.reshape(Kp // GROUP, GROUP, Np)
    scales = torch.clamp_min(_div(wg.abs().amax(dim=1), 7.0), 1e-8)
    q = torch.clamp(torch.round(wg / scales[:, None, :]), -7, 7)
    return pack_w4_frag(q.reshape(Kp, Np).to(torch.int8)), scales, N


# ---------------------------------------------------------------------------
# plain math of the quantized linears
# ---------------------------------------------------------------------------

def quantize_act_int8(x: torch.Tensor):
    """pallas_w8.py:40-47: per-token int8, `sx = max(amax / 127, 1e-8)`.
    [.., K] -> (int8 [.., K], f32 [.., 1])."""
    xf = x.float()
    sx = torch.clamp_min(_div(xf.abs().amax(dim=-1, keepdim=True), 127.0),
                         1e-8)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_act_w4(x: torch.Tensor, reciprocal: bool = False):
    """The W4A8 activation quantization (quant.py:151-154, w4_fused.py:
    72-73, 275-278): `sx = max(amax, 1e-8) / 127` -- a different formula
    from `quantize_act_int8`'s.  [.., K] -> (int8, f32 [.., 1]).

    reciprocal: `sx = max(amax, 1e-8) * f32(1/127)` instead, which is what
    XLA compiles `/ 127.0` into inside a jitted function (its algebraic
    simplifier turns a division by a constant into a multiplication by the
    reciprocal; the CPU HLO shows `multiply(.., 0.00787401572)`).  The
    wrapper of `w4_matmul_grouped` (pallas_w4.py:170-173) is such a
    function; the Pallas kernel bodies and op-by-op calls keep the
    quotient."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8)
    sx = amax * INV_127 if reciprocal else _div(amax, 127.0)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def int_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact a8 [T, K] @ w8[N, K]^T of int8 codes as f64 (every partial sum
    is an integer far below 2^53, so any order is exact and no TF32 mode
    can touch it)."""
    return a8.double() @ w8.double().t()


def linear_w4_reference(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, out_features: int,
                        preferred=None) -> torch.Tensor:
    """`_linear_w4`'s CPU math (quant.py:141-167), the oracle of
    tests/test_w4_fused.py: per-token A8 codes, exact group dots, the
    grouped scales applied by one contraction over the groups, times the
    row scale, rounded to bf16, trimmed, cast to `preferred` or x's dtype."""
    K = packed.shape[1] * GROUP
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x2d.shape[-1] != K:
        x2d = torch.nn.functional.pad(x2d, (0, K - x2d.shape[-1]))
    x8, sx = quantize_act_w4(x2d)
    w = unpack_w4(packed)
    G = K // GROUP
    acc = torch.einsum("tgk,gkn->tgn", x8.double().reshape(-1, G, GROUP),
                       w.double().reshape(G, GROUP, -1)).float()
    y = (torch.einsum("tgn,gn->tn", acc, scales) * sx).to(torch.bfloat16)
    y = y[:, :out_features].to(preferred or x.dtype)
    return y.reshape(*lead, out_features)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Int8Linear(nn.Module):
    """A linear with int8 per-channel weights: `weight_q` [N, K] int8 and
    `scale` [N] f32 (JAX `kernel_q` [K, N] transposed, `scale`)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.empty(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(
            out_features, dtype=torch.float32, device=device))

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        if lin.bias is not None:
            raise NotImplementedError("quantized linears with a bias")
        m = cls(lin.in_features, lin.out_features, device="meta")
        m.weight_q, m.scale = quantize_linear(lin.weight)
        return m

    def forward(self, x: torch.Tensor, act_int8: bool = False,
                preferred=None) -> torch.Tensor:
        if act_int8:
            from .w8a8 import linear_w8a8

            return linear_w8a8(x, self.weight_q, self.scale, preferred)
        # quant.py:176-179: the codes cast to x's dtype, the product in
        # `preferred` (exact upcasts), then the scale -- a plain matmul in
        # the JAX package too (XLA's), so torch.matmul on every device
        dt = preferred or x.dtype
        y = x.to(dt) @ self.weight_q.to(dt).t()
        return y * self.scale.to(dt)


class Int4Linear(nn.Module):
    """A linear with grouped int4 weights in the fragment layout: `packed`
    [Np/8, Kp/128, 512] uint8 and `scales` [Kp/128, Np] f32, the true
    `out_features` N <= Np (the JAX `__trim_N__`)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        Kp = padded_in_dim(in_features)
        Np = -(-out_features // N_PAD) * N_PAD
        self.register_buffer("packed", torch.empty(
            Np // 8, Kp // GROUP, 512, dtype=torch.uint8, device=device))
        self.register_buffer("scales", torch.empty(
            Kp // GROUP, Np, dtype=torch.float32, device=device))

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int4Linear":
        if lin.bias is not None:
            raise NotImplementedError("quantized linears with a bias")
        m = cls(lin.in_features, lin.out_features, device="meta")
        m.packed, m.scales, _ = quantize_linear4(lin.weight)
        return m

    @property
    def padded(self) -> bool:
        return self.out_features != self.scales.shape[1]

    def forward(self, x: torch.Tensor, act_int8: bool = False,
                preferred=None) -> torch.Tensor:
        """`_linear_w4` (quant.py:120-167): on the card the grouped W4A8
        kernel (pallas_w4.py:129, ops/w4_grouped.py) on bf16 rows, K
        zero-padded, the padded N trimmed; on the CPU the JAX package's
        own CPU math (`linear_w4_reference`)."""
        if not x.is_cuda:
            return linear_w4_reference(x, self.packed, self.scales,
                                       self.out_features, preferred)
        from .w4_grouped import w4_matmul_grouped

        K = self.packed.shape[1] * GROUP
        lead = x.shape[:-1]
        x2d = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        if x2d.shape[-1] != K:
            x2d = torch.nn.functional.pad(x2d, (0, K - x2d.shape[-1]))
        y = w4_matmul_grouped(x2d.contiguous(), self.packed, self.scales)
        y = y[:, :self.out_features].to(preferred or x.dtype)
        return y.reshape(*lead, self.out_features)


def quantize_module(lin: nn.Linear, bits: int) -> nn.Module:
    """quantize_params' per-linear choice (llada.py:827-834): bits 8 ->
    int8; bits 4 -> int4 unless K breaks the 128-group, then int8."""
    if bits == 4 and lin.in_features % GROUP == 0:
        return Int4Linear.from_linear(lin)
    return Int8Linear.from_linear(lin)
