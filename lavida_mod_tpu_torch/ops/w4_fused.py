"""Fused W4A8 decode-layer ops: the port of lavida_mod_tpu/ops/w4_fused.py
(kernels #5 `w4_qkv_norm`, #6 `w4_matmul_res`, #7 `w4_ffn_fused`).

  w4_qkv_norm   RMSNorm -> per-token int8 -> grouped-int4 dot -> * sx
                (+ bias) (the fused [q|k|v] projection, with Qwen2's QKV
                bias for Dream, and the logits head on ln_f)
  w4_matmul_res A8 quantization of `a`, grouped-int4 dot, * sa + res
                (the attention output projection and its residual)
  w4_ffn_fused  RMSNorm -> A8 -> [up|gate] int4 -> bf16 -> SwiGLU (f32 math,
                bf16 result) -> per-token A8 -> down int4 -> + x

The int4 weights are in the fragment layout of ops/quant.py, the grouped
scales [K/128, N] f32 as in the JAX package.  CUDA tensors launch the
kernels of csrc/w4_fused.cu; CPU tensors run the `*_reference` plain
versions, which port `_rms_quant` (w4_fused.py:65-75) and `_group_dot_acc`
(:46-62) exactly: each 128-group's integer dot is exact, and the f32
accumulator takes `acc + d_g * s_g` group by group, in order, as the
kernels do.  Each op counts its calls on the card in `.launches`, one per
call.  All three run on the weight-streaming GEMM of csrc/w4_stream.cuh,
32 rows at a time, each GEMM chained to the row pass before it by
programmatic dependent launch: two launches per 32 rows for `w4_qkv_norm`
(the norm pass, the GEMM; laid out by `qkv_plan`) and `w4_matmul_res`
(the quant pass, the GEMM; `res_plan`), four for `w4_ffn_fused` (two row
passes, two GEMMs; `ffn_plan`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import kernels
from .quant import GROUP, quantize_act_w4, unpack_w4

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rms_quant(x: torch.Tensor, norm_w: torch.Tensor, eps: float):
    """`_rms_quant`: RMSNorm with f32 statistics and a bf16 affine, then
    the W4A8 per-token int8.  x [T, D] -> (x8 int8 [T, D], sx f32 [T, 1])."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    h = (xf * torch.rsqrt(var + eps)).to(torch.bfloat16)
    h = (h * norm_w.to(torch.bfloat16)).float()
    return quantize_act_w4(h)


def group_dot_acc(x8: torch.Tensor, packed: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """`_group_dot_acc` over the whole K: sum_g scales[g] * (x8[:, g] @
    W[g]) in f32, group by group.  x8 [T, K] int8 -> [T, N] f32."""
    w = unpack_w4(packed)
    K, N = w.shape
    G = K // GROUP
    d = torch.einsum("tgk,gkn->gtn", x8.double().reshape(-1, G, GROUP),
                     w.double().reshape(G, GROUP, N)).float()
    acc = torch.zeros(x8.shape[0], N, dtype=torch.float32, device=x8.device)
    for g in range(G):
        acc = acc + d[g] * scales[g]
    return acc


def w4_qkv_norm_reference(x, norm_w, packed, scales, eps, bias=None):
    """The optional bias [N] is added in f32 before the one bf16 rounding
    (w4_fused.py:138-140, 195-197)."""
    x8, sx = rms_quant(x, norm_w, eps)
    acc = group_dot_acc(x8, packed, scales) * sx
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(torch.bfloat16)


def w4_matmul_res_reference(a, res, packed, scales):
    a8, sa = quantize_act_w4(a)
    acc = group_dot_acc(a8, packed, scales)
    return (acc * sa + res.float()).to(torch.bfloat16)


def swiglu_quant(prod: torch.Tensor):
    """The SwiGLU transition of w4_ffn_fused (w4_fused.py:397-422): prod
    [T, 2H] bf16 = [up | gate]; inter = (g * sigmoid(g)) * up in f32,
    rounded to bf16; then per-token A8.  -> (a8, sa, inter)."""
    H = prod.shape[1] // 2
    up, g = prod[:, :H].float(), prod[:, H:].float()
    inter = (g * torch.sigmoid(g) * up).to(torch.bfloat16)
    a8, sa = quantize_act_w4(inter)
    return a8, sa, inter


def w4_ffn_fused_reference(x, norm_w, up_packed, up_scales, dn_packed,
                           dn_scales, eps):
    x8, sx = rms_quant(x, norm_w, eps)
    prod = (group_dot_acc(x8, up_packed, up_scales) * sx).to(torch.bfloat16)
    a8, sa, _ = swiglu_quant(prod)
    Hd = dn_packed.shape[1] * GROUP
    if Hd != a8.shape[1]:      # down K zero-padded (padded_in_dim)
        a8 = torch.nn.functional.pad(a8, (0, Hd - a8.shape[1]))
    acc = group_dot_acc(a8, dn_packed, dn_scales)
    return (acc * sa + x.float()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the plans of the weight-streaming GEMMs (csrc/w4_stream.cuh): w4_qkv_norm's,
# w4_matmul_res's and w4_ffn_fused's two
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448          # dynamic shared memory a block can use
ROWS = 32                    # rows per launch (two m16 tiles)
ROW_PAD = 16                 # bytes after each row of an activation slice
BAR_BYTES = 128              # the ring's mbarriers
MAX_STAGES = 6
MIN_STAGES = 3
IN_FLIGHT_MIN = 32 * 1024    # bytes the producer keeps in flight per SM
# (groups per stage, column units per pass) of each GEMM, as in
# csrc/w4_fused.cu: up|gate units are (up, gate) tile pairs, the others'
# single n8 tiles.  w4_qkv_norm's stage is 4 groups of 12 tiles: at [q|k|v]
# (1536 tiles over 132 CTAs) a CTA's tiles take one pass, so the codes'
# K-slices cross L2 once per CTA and not once per 4 tiles.  w4_matmul_res's
# is 8 groups of 4 tiles: at [32, 4096] x 4096 a CTA's 4 tiles take one
# pass and all their weights fit in the ring (PERF.md, the stage-shape
# table of #6).
QKV_SLICE_GROUPS, QKV_PASS_UNITS = 4, 12
RES_SLICE_GROUPS, RES_PASS_UNITS = 8, 4
UP_SLICE_GROUPS, UP_PASS_UNITS = 8, 4
DN_SLICE_GROUPS, DN_PASS_UNITS = 8, 4


def slice_bytes(sg: int, G: int) -> int:
    """Bytes of 32 rows of G groups of codes in the slice layout: K cut
    into slices of `sg` groups, each slice [32, ng * 128 + 16]."""
    return ROWS * (G * GROUP + ROW_PAD * -(-G // sg))


class GemmPlan(NamedTuple):
    ctas: int         # persistent CTAs; CTA c owns units [c*units//ctas, ..)
    units: int        # column units
    tiles: int        # n8 tiles per unit
    slice_groups: int # groups per stage (and per slice of the codes)
    stages: int       # ring stages
    stage_bytes: int  # codes' K-slice + the weights of a pass's units
    smem: int         # dynamic shared memory per CTA, the scales included

    def owned(self, c: int) -> range:
        return range(c * self.units // self.ctas,
                     (c + 1) * self.units // self.ctas)


class PassPlan(NamedTuple):
    """A row pass and a GEMM per 32 rows (w4_qkv_norm, w4_matmul_res)."""
    row_slices: int
    gemm: GemmPlan
    # byte offsets of the codes and their row scales in one workspace of
    # `work_bytes`
    offsets: tuple
    work_bytes: int


class FfnPlan(NamedTuple):
    row_slices: int
    up: GemmPlan
    down: GemmPlan
    # byte offsets of x8, a8, inter, sx, amax and sa in one workspace of
    # `work_bytes` (the scratch of one 32-row slice, reused by the next)
    offsets: tuple
    work_bytes: int


def _gemm_plan(G, units, tiles, sg, pu, sms) -> GemmPlan:
    """One CTA per SM, or a multiple of that where a CTA's group scales
    would leave fewer than MIN_STAGES stages."""
    stage = ROWS * (sg * GROUP + ROW_PAD) + pu * tiles * sg * 512
    for waves in range(1, units + 1):
        ctas = min(units, waves * sms)
        fixed = BAR_BYTES + G * tiles * -(-units // ctas) * 32   # + scales
        stages = min(MAX_STAGES, max(SMEM_LIMIT - fixed, 0) // stage)
        if stages >= MIN_STAGES or ctas == units:
            break
    return GemmPlan(ctas, units, tiles, sg, stages, stage,
                    fixed + stages * stage)


def _check_ring(op: str, g: GemmPlan, what: str) -> None:
    if g.stages < MIN_STAGES \
            or (g.stages - 1) * g.stage_bytes < IN_FLIGHT_MIN:
        raise ValueError(f"{op}: {what} leave {g.stages} ring stages of "
                         f"{g.stage_bytes} bytes")


def _workspace(sizes):
    """(offsets, total bytes) of regions of `sizes` bytes, each aligned to
    128 bytes, in one buffer."""
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // 128) * 128)
    return tuple(offsets[:-1]), offsets[-1]


@functools.lru_cache(maxsize=64)
def qkv_plan(T: int, D: int, N: int, sms: int) -> PassPlan:
    """CTAs, ring stages and shared bytes of w4_qkv_norm's GEMM for x
    [T, D] and a weight [D -> N] on a card of `sms` SMs, and the scratch of
    its norm pass (the codes of 32 rows in the slice layout, sx)."""
    g = _gemm_plan(D // GROUP, N // 8, 1, QKV_SLICE_GROUPS, QKV_PASS_UNITS,
                   sms)
    _check_ring("w4_qkv_norm", g, f"D = {D}, N = {N}")
    offsets, work = _workspace([slice_bytes(g.slice_groups, D // GROUP),
                                4 * ROWS])
    return PassPlan(-(-T // ROWS), g, offsets, work)


def whole_pass_ctas(units: int, pu: int, sms: int) -> int:
    """The fewest CTAs for `units` column units whose longest CTA takes no
    more passes of `pu` units than with one CTA per SM (`sms`): at 512
    units, 4 a pass and 132 SMs, 128 CTAs of 4."""
    per = -(-(-(-units // sms)) // pu) * pu
    return -(-units // per)


@functools.lru_cache(maxsize=64)
def res_plan(T: int, K: int, N: int, sms: int) -> PassPlan:
    """CTAs, ring stages and shared bytes of w4_matmul_res's GEMM for a
    [T, K] and a weight [K -> N] on a card of `sms` SMs, and the scratch of
    its quant pass (the codes of 32 rows in the slice layout, sa).  The
    CTAs are `whole_pass_ctas`: at 4096 columns 128 CTAs of 4 tiles, where
    one per SM gives 132 CTAs of 3-4 tiles, the longest as long, and the
    codes' K-slices cross L2 4 more times."""
    units = N // 8
    g = _gemm_plan(K // GROUP, units, 1, RES_SLICE_GROUPS, RES_PASS_UNITS,
                   whole_pass_ctas(units, RES_PASS_UNITS, sms))
    _check_ring("w4_matmul_res", g, f"K = {K}, N = {N}")
    offsets, work = _workspace([slice_bytes(g.slice_groups, K // GROUP),
                                4 * ROWS])
    return PassPlan(-(-T // ROWS), g, offsets, work)


@functools.lru_cache(maxsize=64)
def ffn_plan(T: int, D: int, H: int, Hd: int, sms: int) -> FfnPlan:
    """CTAs, ring stages and shared bytes of w4_ffn_fused's GEMMs for x
    [T, D], up|gate [D -> 2H], down [Hd -> D] on a card of `sms` SMs, and
    the scratch of its passes."""
    up = _gemm_plan(D // GROUP, H // 8, 2, UP_SLICE_GROUPS, UP_PASS_UNITS,
                    sms)
    down = _gemm_plan(Hd // GROUP, D // 8, 1, DN_SLICE_GROUPS, DN_PASS_UNITS,
                      sms)
    for g in (up, down):
        _check_ring("w4_ffn_fused", g, f"D = {D}, Hd = {Hd}")
    offsets, work = _workspace([slice_bytes(up.slice_groups, D // GROUP),
                                slice_bytes(down.slice_groups, Hd // GROUP),
                                2 * ROWS * H, 4 * ROWS, 4 * ROWS, 4 * ROWS])
    return FfnPlan(-(-T // ROWS), up, down, offsets, work)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _need(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous 16-byte aligned {dtype} "
                         f"{shape} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _weights(op, packed, scales, K, device):
    """(N) of a fragment-layout weight with K input rows, checked."""
    if packed.dim() != 3 or packed.shape[1] * GROUP != K \
            or packed.shape[2] != 512:
        raise ValueError(f"{op}: packed {tuple(packed.shape)} does not hold "
                         f"K = {K} rows in the fragment layout")
    N = packed.shape[0] * 8
    if N % 32:
        raise ValueError(f"{op}: N = {N} must be a multiple of 32")
    _need(f"{op}: packed", packed, torch.uint8, tuple(packed.shape), device)
    _need(f"{op}: scales", scales, torch.float32, (K // GROUP, N), device)
    return N


def _rows(op, x, width):
    T = x.shape[0]
    if x.dim() != 2 or x.shape[1] != width or T < 1:
        raise ValueError(f"{op}: x {tuple(x.shape)}, want [T, {width}]")
    _need(f"{op}: x", x, torch.bfloat16, (T, width), x.device)
    return T


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def w4_qkv_norm(x, norm_w, packed, scales, eps: float = 1e-5, bias=None):
    """rmsnorm(x) @ W4 (+ bias) -> [T, N] bf16, with the norm and A8
    quantization in a row pass before each 32 rows' GEMM.  x [T, D] bf16,
    norm_w [D] bf16, bias [N] bf16 or None (Qwen2's QKV bias, added in f32
    before the bf16 rounding)."""
    if not x.is_cuda:
        return w4_qkv_norm_reference(x, norm_w, packed, scales, eps, bias)
    D = packed.shape[1] * GROUP
    T = _rows("w4_qkv_norm", x, D)
    N = _weights("w4_qkv_norm", packed, scales, D, x.device)
    _need("w4_qkv_norm: norm_w", norm_w, torch.bfloat16, (D,), x.device)
    if bias is not None:
        _need("w4_qkv_norm: bias", bias, torch.bfloat16, (N,), x.device)
    plan = qkv_plan(T, D, N, _sms(x.device.index))
    g = plan.gemm
    work = torch.empty(plan.work_bytes, dtype=torch.uint8, device=x.device)
    x8, sx = (work.data_ptr() + o for o in plan.offsets)
    out = torch.empty(T, N, dtype=torch.bfloat16, device=x.device)
    kernels.check(kernels.library().lavida_w4_qkv_norm_bias(
        x.data_ptr(), norm_w.data_ptr(), packed.data_ptr(),
        scales.data_ptr(), None if bias is None else bias.data_ptr(), x8,
        sx, out.data_ptr(), T, D, N, eps, g.ctas, g.stages, g.smem,
        _stream(x)), "w4_qkv_norm")
    w4_qkv_norm.launches += 1
    return out


def w4_matmul_res(a, res, packed, scales):
    """res + (a @ W4) -> [T, N] bf16, a [T, K] and res [T, N] bf16, with
    the A8 quantization of `a` in a row pass before each 32 rows' GEMM."""
    if not a.is_cuda:
        return w4_matmul_res_reference(a, res, packed, scales)
    K = packed.shape[1] * GROUP
    T = _rows("w4_matmul_res", a, K)
    N = _weights("w4_matmul_res", packed, scales, K, a.device)
    _need("w4_matmul_res: res", res, torch.bfloat16, (T, N), a.device)
    plan = res_plan(T, K, N, _sms(a.device.index))
    g = plan.gemm
    work = torch.empty(plan.work_bytes, dtype=torch.uint8, device=a.device)
    a8, sa = (work.data_ptr() + o for o in plan.offsets)
    out = torch.empty(T, N, dtype=torch.bfloat16, device=a.device)
    kernels.check(kernels.library().lavida_w4_matmul_res(
        a.data_ptr(), res.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        a8, sa, out.data_ptr(), T, K, N, g.ctas, g.stages, g.smem,
        _stream(a)), "w4_matmul_res")
    w4_matmul_res.launches += 1
    return out


def w4_ffn_fused(x, norm_w, up_packed, up_scales, dn_packed, dn_scales,
                 eps: float = 1e-5):
    """x + down(swiglu(rmsnorm(x) @ W_upgate)) -> [T, D] bf16.  up|gate
    [D -> 2H] with up first; down [Hd -> D], Hd >= H (zero rows past H)."""
    if not x.is_cuda:
        return w4_ffn_fused_reference(x, norm_w, up_packed, up_scales,
                                      dn_packed, dn_scales, eps)
    D = up_packed.shape[1] * GROUP
    T = _rows("w4_ffn_fused", x, D)
    H2 = _weights("w4_ffn_fused: up", up_packed, up_scales, D, x.device)
    Hd = dn_packed.shape[1] * GROUP
    H = H2 // 2
    if H % 32 or Hd < H or Hd % GROUP:
        raise ValueError(f"w4_ffn_fused: H = {H}, Hd = {Hd}")
    if _weights("w4_ffn_fused: down", dn_packed, dn_scales, Hd,
                x.device) != D:
        raise ValueError("w4_ffn_fused: down must map back to D")
    _need("w4_ffn_fused: norm_w", norm_w, torch.bfloat16, (D,), x.device)
    plan = ffn_plan(T, D, H, Hd, _sms(x.device.index))
    up, dn = plan.up, plan.down
    work = torch.empty(plan.work_bytes, dtype=torch.uint8, device=x.device)
    x8, a8, inter, sx, amax, sa = (work.data_ptr() + o for o in plan.offsets)
    out = torch.empty(T, D, dtype=torch.bfloat16, device=x.device)
    kernels.check(kernels.library().lavida_w4_ffn_fused(
        x.data_ptr(), norm_w.data_ptr(), up_packed.data_ptr(),
        up_scales.data_ptr(), dn_packed.data_ptr(), dn_scales.data_ptr(),
        x8, sx, amax, inter, a8, sa, out.data_ptr(), T, D, H, Hd, eps,
        up.ctas, up.stages, up.smem, dn.ctas, dn.stages, dn.smem,
        _stream(x)), "w4_ffn_fused")
    w4_ffn_fused.launches += 1
    return out


w4_qkv_norm.launches = 0
w4_matmul_res.launches = 0
w4_ffn_fused.launches = 0
