"""Per-channel int4 weight matmul: the port of lavida_mod_tpu/ops/
pallas_w4.py's `w4_matmul` (kernel #11), at its public layout.

`w4_matmul(x2, packed, scale)`: x2 [2, T, K/2] bf16 is `split_even_odd`
of x [T, K] (the even and the odd K columns), packed [K/2, N] int8 is
`quant.pack_w4` of the int4 codes (row 2k in the low nibble of byte k,
row 2k + 1 in the high one, both signed), scale [N] f32 is per output
channel.  The result is bf16((x_even @ lo + x_odd @ hi) * scale), the dots
taken in f32 over the exactly converted nibbles (pallas_w4.py:64-77).
CUDA tensors launch csrc/w4_matmul.cu, a persistent swap-AB wgmma GEMM
with the weights widened in registers as the A operand, on the layout that
`plan` picks from the shapes: up to DECODE_MAX_ROWS rows the decode plan
(one row block of 8, 16, 32 or 64 rows, the weights streamed past it),
more rows the prefill plan (row blocks of 128 or 256), both on units of
128 columns, with K split when the units would leave SMs idle.  Nothing
falls back to the plain version: a failed build or launch raises.  CPU
tensors run `w4_matmul_reference`, which computes in the TPU kernel's
order: the two f32 products, their sum, the scale, then bf16.  The kernel
sums the two products' terms in one accumulator, split by split, in
another order (fixed for a plan, so a call gives the same bits every
run), so the two agree within one bf16 rounding
(tests/test_torch_w4_matmul.py).

No model leaf or serving path builds this layout in either package (the
int4 serving layouts are grouped, ops/w4_grouped.py); the JAX package
exercises the kernel in tests/test_pallas_w4.py, and the port holds it
the same way.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


# The plan's constants (csrc/w4_matmul.cu mirrors each one and refuses a
# plan that does not match): a unit is COLS columns (two consumer
# warpgroups of one wgmma M each) by bt rows (the wgmma N) by a split of
# K; a ring stage holds the same STAGE_ROWS columns of x_even and x_odd
# (128 bytes a row) and STAGE_ROWS packed rows of the unit's weights (COLS
# bytes a row).
STAGE_ROWS = 64
COLS = 128
DECODE_MAX_ROWS = 64
DECODE_ROWS = (8, 16, 32, 64)
PREFILL_ROWS = (128, 256)
MAX_SPLITS = 16
MAX_STAGES = 8
SMEM_LIMIT = 232448          # shared memory a block can use


def stage_bytes(bt: int) -> int:
    """A ring stage: the x_even and x_odd tiles of bt rows, then the
    weights (a multiple of 1024 bytes, the swizzle's alignment)."""
    return 2 * bt * 128 + STAGE_ROWS * COLS


def ring_stages(bt: int) -> int:
    return min(MAX_STAGES, (SMEM_LIMIT - 1024) // stage_bytes(bt))


class Plan(NamedTuple):
    regime: str       # "decode" (T <= DECODE_MAX_ROWS) or "prefill"
    bt: int           # rows per unit (the wgmma N)
    row_blocks: int   # units along T
    col_tiles: int    # units along N (the last ragged)
    kblocks: int      # stages of STAGE_ROWS packed rows along K/2
    splits: int       # K splits per tile
    kps: int          # stages per split (the last split fewer)
    units: int        # row_blocks x col_tiles x splits
    ctas: int         # persistent CTAs; CTA c takes units c, c + ctas, ...
    stages: int       # ring stages
    smem: int         # dynamic shared bytes (ring + 1024 alignment slack)

    @property
    def tiles(self) -> int:
        return self.row_blocks * self.col_tiles

    @property
    def part_floats(self) -> int:
        """The split partials' workspace (0 without a split)."""
        return 0 if self.splits == 1 else self.splits * self.tiles * self.bt * COLS


# The plan's cost model, in units of ~4.7 ns of an H100 (a decode stage
# takes ~0.45 us), fitted to the split and row-block variants of
# w4_matmul_variants.py at the decode, prefill and ragged shapes: a stage
# costs the larger of its fixed share (the weight stream, the widening and
# the small products: STAGE_COST) and its products (bt + 16); a unit adds
# UNIT_COST (the ring's first stages, the epilogue, the launch spread over
# the waves), and a split unit SPLIT_COST_PER_ROW x bt more for its
# partials (written, then read by the last split).
STAGE_COST = 96
UNIT_COST = 700
SPLIT_COST_PER_ROW = 6.6


@functools.lru_cache(maxsize=256)
def plan(T: int, K2: int, N: int, sms: int) -> Plan:
    """The kernel's layout for x2 [2, T, K2] and packed [K2, N] on a card
    of `sms` SMs.  Up to DECODE_MAX_ROWS rows the unit takes all of them
    (the least of DECODE_ROWS that holds T); beyond, row blocks of 128 or
    256.  K is split into up to MAX_SPLITS ranges of whole stages, none
    empty.  Of these layouts the one whose busiest CTA has the least to do
    by the cost model above is taken; ties go to fewer splits, then to the
    smaller row block.  At the decode shape ([32, 4096] x 12288) that is
    one split on 96 CTAs (on an NVIDIA H100 80GB HBM3, 4 splits on 132
    took 0.0233-0.0240 ms against 0.0184-0.0200), at the prefill's 1056
    rows 9 row blocks of 128 (5 of 256: 0.1705-0.1742 ms against
    0.1615-0.1648), at the ragged [5, 4304] x 1000 12 splits of 3
    stages."""
    if min(T, K2, N, sms) < 1:
        raise ValueError(f"w4_matmul plan: T = {T}, K2 = {K2}, N = {N}, "
                         f"sms = {sms}")
    kind = "decode" if T <= DECODE_MAX_ROWS else "prefill"
    bts = ([next(b for b in DECODE_ROWS if b >= T)] if kind == "decode"
           else list(PREFILL_ROWS))
    col_tiles = -(-N // COLS)
    kblocks = -(-K2 // STAGE_ROWS)
    best = None
    for bt in bts:
        row_blocks = -(-T // bt)
        for splits in range(1, min(MAX_SPLITS, kblocks) + 1):
            kps = -(-kblocks // splits)
            if -(-kblocks // kps) != splits:
                continue              # a split would be empty
            units = row_blocks * col_tiles * splits
            cost = -(-units // sms) * (
                kps * max(STAGE_COST, bt + 16) + UNIT_COST
                + (SPLIT_COST_PER_ROW * bt if splits > 1 else 0))
            if best is None or cost < best[0]:
                stages = ring_stages(bt)
                best = (cost, Plan(kind, bt, row_blocks, col_tiles, kblocks,
                                   splits, kps, units, min(units, sms),
                                   stages, 1024 + stages * stage_bytes(bt)))
    return best[1]


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """A zeroed int32 counter per tile, one buffer per stream (the kernel
    leaves it zeroed; calls on one stream never overlap)."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


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
    dev = x2.device
    p = plan(T, K2, N, _sms(dev.index))
    out = torch.empty(T, N, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = counters = None
    if p.splits > 1:
        part = torch.empty(p.part_floats, dtype=torch.float32, device=dev)
        counters = _counters(dev, stream, p.tiles)
    kernels.check(kernels.library().lavida_w4_matmul(
        x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        T, K2, N, p.bt, p.row_blocks, p.col_tiles, p.splits, p.kps, p.ctas,
        p.smem, stream), "w4_matmul")
    w4_matmul.launches += 1
    return out


w4_matmul.launches = 0
