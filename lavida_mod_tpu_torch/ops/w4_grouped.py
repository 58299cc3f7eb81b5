"""Grouped int4 W4A8 matmul: the port of lavida_mod_tpu/ops/pallas_w4.py
(kernel #4, `w4_matmul_grouped`), every LM linear of the unfused int4
serving layout.

`w4_matmul_grouped(x, packed, scales)`: x [T, K] bf16 is quantized per
token (`sx = max(amax, 1e-8) / 127`, pallas_w4.py:170-173, which XLA
compiles into `max(amax, 1e-8) * f32(1/127)`, so the port computes that:
`quant.quantize_act_w4(reciprocal=True)`), the codes are
multiplied with the grouped int4 weights (fragment layout of ops/quant.py,
scales [K/128, N] f32) and the result is bf16 [T, N].  CUDA tensors run the
row quantization kernel of csrc/w4_fused.cu and a GEMM of
csrc/w4_grouped.cu, chosen by the row count alone (`regime`), each a
wgmma GEMM with the int4 weights widened in registers as the A operand,
launched under programmatic dependent launch after the row pass: T <= 256
rows (`DECODE_MAX_ROWS`, the decode steps and the unfused head) take the
decode kernel, which streams the weights past units of 64 columns and up
to 64 rows (`decode_plan`); more rows (the prefill) take the prefill
kernel, one persistent CTA per SM on units of 128 x 128 rows and
columns, two consumer warpgroups of 64 columns each (`prefill_plan`).
Neither falls back to the other or to the plain version: a failed build or
launch raises.  CPU tensors run `w4_matmul_grouped_reference`, which
follows the TPU kernel's f32 order: inside each k-block of `gb` groups a
partial sum starts at 0 and takes `part + d_g * s_g` group by group, the
partial is added to the accumulator, and the epilogue is bf16(acc * sx)
(pallas_w4.py:212-235).
Both kernels are bit-equal to it; the plain version is bit-equal to the
Pallas kernel in interpret mode too (tests/test_torch_w4_grouped.py).

The JAX model off the TPU takes `_linear_w4`'s einsum fallback instead,
which applies the group scales in one contraction; the port's CPU model
path keeps that one (`quant.linear_w4_reference`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


# The decode kernel's plan (csrc/w4_grouped.cu mirrors each constant and
# refuses a plan that does not match): a unit is 64 columns (one wgmma M)
# by rb rows (the wgmma N of the CTA's consumer warpgroup); a ring stage
# holds DECODE_SLICE_GROUPS groups of the unit's 8 n8 tiles of weights, of
# its rows of codes and of its scales.
DECODE_MAX_ROWS = 256
DECODE_SLICE_GROUPS = 4
DECODE_MAX_STAGES = 8
DECODE_COLS = 64
DECODE_RB = (16, 32, 48, 64)
DECODE_SCALE_BYTES = 1024    # a stage's scales: 4 groups x 64 f32
SMEM_LIMIT = 232448          # shared memory a block can use


def regime(T: int) -> str:
    """Which kernel takes T rows on the card: "decode" up to
    DECODE_MAX_ROWS, else "prefill" (pallas_w4.py:179-182 splits there
    too)."""
    return "decode" if T <= DECODE_MAX_ROWS else "prefill"


class DecodePlan(NamedTuple):
    rb: int           # rows per unit (the wgmma N)
    row_blocks: int   # units along T
    units: int        # (N / 64) column tiles x row_blocks, row blocks inner
    ctas: int         # persistent CTAs; CTA c owns units [c*units//ctas, ..)
    stages: int       # ring stages
    smem: int         # dynamic shared bytes (ring + 1024 alignment slack)

    def owned(self, c: int) -> range:
        return range(c * self.units // self.ctas,
                     (c + 1) * self.units // self.ctas)


def decode_stage_bytes(rb: int) -> int:
    """A ring stage: the unit's 8 n8 tiles and its rows of codes for
    DECODE_SLICE_GROUPS groups, then their scales (1024 bytes, so the next
    stage stays on the swizzle's 1024-byte boundary)."""
    return (8 * 512 + rb * GROUP) * DECODE_SLICE_GROUPS + DECODE_SCALE_BYTES


def decode_layout(T: int, N: int, sms: int, rb: int) -> DecodePlan:
    """The plan of `rb` rows per unit for T rows and N columns."""
    if rb not in DECODE_RB:
        raise ValueError(f"decode plan: rb = {rb}")
    nrb = -(-T // rb)
    stage = decode_stage_bytes(rb)
    stages = min(DECODE_MAX_STAGES, (SMEM_LIMIT - 2048) // stage)
    units = N // DECODE_COLS * nrb
    return DecodePlan(rb, nrb, units, min(units, sms), stages,
                      1024 + stages * stage)


@functools.lru_cache(maxsize=64)
def decode_plan(T: int, N: int, sms: int) -> DecodePlan:
    """The decode kernel's layout for T rows and a weight of N columns on
    a card of `sms` SMs (K does not enter it).  T is cut into row blocks of rb rows (a multiple of
    16, at most 64, no block empty) so that the CTA with the most units has
    the least to read: per unit and group, its rows of codes (128 bytes a
    row) and the unit's 4 KB of weights (as much as 32 rows).  At [128,
    4096] x 4096 two blocks of 64 give 128 units, one per CTA; ties go to
    fewer blocks, which read the weights fewer times."""
    if not 1 <= T <= DECODE_MAX_ROWS or N % DECODE_COLS:
        raise ValueError(f"decode_plan: T = {T}, N = {N}")
    tiles = N // DECODE_COLS
    best = None
    for nrb in range(1, -(-T // 16) + 1):
        rb = -(-(-(-T // nrb)) // 16) * 16
        if rb > DECODE_RB[-1] or (nrb - 1) * rb >= T:
            continue
        cost = -(-tiles * nrb // sms) * (rb + 32)
        if best is None or cost < best[0]:
            best = (cost, rb)
    return decode_layout(T, N, sms, best[1])


# The prefill kernel's plan (csrc/w4_grouped.cu mirrors each constant and
# refuses a plan that does not match): a unit is 128 rows (the wgmma N) by
# 128 columns (two consumer warpgroups of one wgmma M each); a ring stage
# holds PREFILL_SLICE_GROUPS groups of the unit's 16 n8 tiles of weights,
# of its rows of codes and of its scales.
PREFILL_ROWS = 128
PREFILL_COLS = 128
PREFILL_SLICE_GROUPS = 4
PREFILL_MAX_STAGES = 8
PREFILL_SCALE_BYTES = 2048   # a stage's scales: 4 groups x 128 f32


class PrefillPlan(NamedTuple):
    col_tiles: int    # units along N (the last half empty if N % 128 = 64)
    row_blocks: int   # units along T (the last ragged)
    units: int        # col_tiles x row_blocks; unit u is the row block
    #                   u // col_tiles and the column tile u % col_tiles
    ctas: int         # persistent CTAs; CTA c owns units c, c + ctas, ...
    stages: int       # ring stages
    smem: int         # dynamic shared bytes (ring + 1024 alignment slack)

    def owned(self, c: int) -> range:
        return range(c, self.units, self.ctas)


def prefill_stage_bytes() -> int:
    """A ring stage: the unit's 16 n8 tiles and its 128 rows of codes for
    PREFILL_SLICE_GROUPS groups, then their scales (2048 bytes, so the next
    stage stays on the swizzle's 1024-byte boundary)."""
    return ((16 * 512 + PREFILL_ROWS * GROUP) * PREFILL_SLICE_GROUPS
            + PREFILL_SCALE_BYTES)


@functools.lru_cache(maxsize=64)
def prefill_plan(T: int, N: int, sms: int) -> PrefillPlan:
    """The prefill kernel's layout for T > DECODE_MAX_ROWS rows and a
    weight of N columns on a card of `sms` SMs (K does not enter it): one
    CTA per SM, or one per unit if there are fewer; as many ring stages as
    shared memory holds."""
    if T <= DECODE_MAX_ROWS or N <= 0 or N % DECODE_COLS:
        raise ValueError(f"prefill_plan: T = {T}, N = {N}")
    col_tiles = -(-N // PREFILL_COLS)
    row_blocks = -(-T // PREFILL_ROWS)
    units = col_tiles * row_blocks
    stage = prefill_stage_bytes()
    stages = min(PREFILL_MAX_STAGES, (SMEM_LIMIT - 2048) // stage)
    return PrefillPlan(col_tiles, row_blocks, units, min(units, sms), stages,
                       1024 + stages * stage)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def w4_matmul_grouped(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """x [T, K] bf16 @ grouped int4 W [K, N] -> [T, N] bf16 (N the padded
    width of `packed`; the caller trims).  On the card T <= 256 rows take
    the decode kernel and count in `.decode_launches`, more rows the
    prefill kernel and `.prefill_launches`; `.launches` counts both."""
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if regime(T) == "decode":
        p = decode_plan(T, N, _sms(x.device.index))
        kernels.check(kernels.library().lavida_w4_grouped_decode(
            x8.data_ptr(), sx.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), out.data_ptr(), T, K, N, groups_per_kblock(K),
            p.rb, p.row_blocks, p.ctas, p.stages, p.smem, stream),
            "w4_matmul_grouped (decode)")
        w4_matmul_grouped.decode_launches += 1
    else:
        p = prefill_plan(T, N, _sms(x.device.index))
        kernels.check(kernels.library().lavida_w4_grouped(
            x8.data_ptr(), sx.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), out.data_ptr(), T, K, N, groups_per_kblock(K),
            p.col_tiles, p.row_blocks, p.ctas, p.stages, p.smem, stream),
            "w4_matmul_grouped (prefill)")
        w4_matmul_grouped.prefill_launches += 1
    w4_matmul_grouped.launches += 1
    return out


w4_matmul_grouped.launches = 0
w4_matmul_grouped.decode_launches = 0
w4_matmul_grouped.prefill_launches = 0
