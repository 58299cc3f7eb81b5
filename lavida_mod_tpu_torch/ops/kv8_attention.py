"""Decode attention over an int8 KV cache: the port of
lavida_mod_tpu/ops/kv8_attention.py (kernel #8, `kv8_decode_attention`,
and its host-side helpers), the worker's and bench's `--kv8` flag.

Layout, as in the JAX package: K/V as int8 codes [B, Hkv, S, hd]
(head-major) with per-(batch, head, position) f32 scales [B, Hkv, 1, S],
`scale = max(amax over hd, 1e-8) / 127`.

  - `quantize_kv` / `dequantize_kv` (kv8_attention.py:41-62): plain torch,
    as the JAX package computes them in XLA.
  - `write_rows` (:152-163): this step's rows quantized and written IN
    PLACE into the preallocated int8 buffers (the JAX package's
    dynamic_update_slice, without its functional copy).
  - `kv8_decode_attention` (:98-149): CUDA tensors launch the kernel of
    csrc/kv8_attention.cu; CPU tensors run the plain version, which follows
    the TPU kernel's order: scores (q . k8) * (ks * sm_scale) in f32,
    masked to -1e30 (a row that sees no valid key averages over all S),
    the whole row softmaxed, p * vs rounded to bf16, the PV product in f32,
    the result in q's dtype.

The kernel streams each (batch row, KV head)'s cache once through a TMA
ring with an online softmax, so it takes any S, and a head dim of 16, 32,
64, 128 or 256 (a multiple of 16 dividing 256).  `kv8_plan` lays it out:
row tiles, key splits, key chunks (merged by a second kernel when there is
more than one) and ring stages; csrc/kv8_attention.cu mirrors its constants
and refuses a plan that does not match.  It rounds bf16(exp(s - m_running)
* vs) where the TPU rounds bf16(p_norm * vs), within the 6e-3 band of
tests/test_kv8.py.

The int4 cache (`--kv4`) is not ported: `quantize_kv(bits=4)` raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import kernels

NEG_INF = -1e30


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """[B, S, H, hd] float -> (int8 [B, H, S, hd], f32 [B, H, 1, S])."""
    if bits != 8:
        raise NotImplementedError("the int4 KV cache (kv4) is not ported")
    xf = x.transpose(1, 2).float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale[..., 0][:, :, None, :].contiguous()


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_kv -> [B, S, H, hd] f32."""
    return (q.float() * scale[:, :, 0, :, None]).transpose(1, 2)


@torch.no_grad()
def write_rows(k8, ks, v8, vs, k_new, v_new, index: int):
    """Quantize this call's rows k_new/v_new [B, T, H, hd] and write them at
    positions [index, index + T) of the int8 cache, in place.  Returns the
    same four buffers."""
    T = k_new.shape[1]
    for buf, sbuf, new in ((k8, ks, k_new), (v8, vs, v_new)):
        q, s = quantize_kv(new)
        buf[:, :, index:index + T].copy_(q)
        sbuf[..., index:index + T].copy_(s)
    return k8, ks, v8, vs


def kv8_decode_attention_reference(q, k8, ks, v8, vs, kv_valid=None):
    """Plain version (see the module note).  q [B, T, H, hd]."""
    B, T, H, hd = q.shape
    Hkv, S = k8.shape[1], k8.shape[2]
    G = H // Hkv
    qh = q.transpose(1, 2).float().reshape(B, Hkv, G * T, hd)
    s = (qh @ k8.float().transpose(-1, -2)).view(B, Hkv, G, T, S)
    kcol = ks * torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
    s = s * kcol[:, :, None]                         # [B, Hkv, 1, 1, S]
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, None, :], s,
                        torch.tensor(NEG_INF, dtype=torch.float32,
                                     device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    pv = (p * vs[:, :, None]).to(torch.bfloat16).float()
    out = pv.view(B, Hkv, G * T, S) @ v8.float()     # [B, Hkv, G*T, hd]
    return out.view(B, H, T, hd).transpose(1, 2).to(q.dtype)


# The kernel's plan (csrc/kv8_attention.cu mirrors each constant and refuses
# a plan that does not match): a unit is (batch row, KV head, row block, key
# chunk); a row block is up to KV8_MAX_WARPS 16-row tiles of the G*T query
# rows that share the KV head (half at hd 256), each tile one warp per key
# split; a ring stage holds KV8_KEYS keys of K and V and their scales and
# mask bytes (KV8_SCALE_BYTES), and the ring KV8_STAGES stages (the kernel
# takes up to KV8_MAX_STAGES).
KV8_KEYS = 128
KV8_MAX_STAGES = 6
KV8_STAGES = 2               # the ring depth taken: 2 read fastest (PERF.md)
KV8_MAX_WARPS = 8
KV8_SCALE_BYTES = 2048
KV8_MAX_G = 16
SMEM_LIMIT = 232448          # shared memory a block can use


class Kv8Plan(NamedTuple):
    row_tiles: int    # 16-row tiles per unit
    row_blocks: int   # units along the G*T rows
    splits: int       # consumer warps per row tile, each a share of the keys
    chunks: int       # units along S (merged in chunk order when > 1)
    stages: int       # ring stages
    smem: int         # dynamic shared bytes (ring or merge area + 1024)
    units: int        # B x Hkv x row_blocks x chunks


def kv8_stage_bytes(hd: int) -> int:
    """A ring stage: KV8_KEYS rows of K and of V, then their scales and
    mask bytes."""
    return 2 * KV8_KEYS * hd + KV8_SCALE_BYTES


def kv8_plan(B: int, T: int, H: int, Hkv: int, S: int, hd: int,
             sms: int) -> Kv8Plan:
    """The kernel's layout for q [B, T, H, hd] over S keys on a card of
    `sms` SMs.  The G*T rows of a KV head are cut into the fewest row
    blocks of at most KV8_MAX_WARPS 16-row tiles (half at hd 256); each
    tile gets 4, 2 or 1 warps that share each stage's keys, as many as the
    warps allow.  The keys are cut into chunks so that the SM with the most
    units has the fewest tiles to stream (one CTA per SM), counting the
    merge of more than one chunk as a tile; ties go to fewer chunks.  At
    B = 4 LLaDA (128 (batch row, KV head) pairs) that is one chunk; at B = 4
    Dream (Hkv = 4, G = 7: 32 row blocks) four."""
    if B < 1 or T < 1 or S < 1 or Hkv < 1 or H % Hkv \
            or H // Hkv > KV8_MAX_G or hd not in (16, 32, 64, 128, 256):
        raise ValueError(f"kv8_plan: B {B} T {T} H {H} Hkv {Hkv} S {S} "
                         f"hd {hd}")
    max_warps = KV8_MAX_WARPS if hd <= 128 else KV8_MAX_WARPS // 2
    mt = -(-(H // Hkv * T) // 16)
    row_blocks = -(-mt // max_warps)
    row_tiles = -(-mt // row_blocks)
    splits = next(k for k in (4, 2, 1) if k * row_tiles <= max_warps)
    tiles = -(-S // KV8_KEYS)
    pairs = B * Hkv * row_blocks
    best = None
    for c in range(1, tiles + 1):
        per = -(-tiles // c)
        if (c - 1) * per >= tiles:
            continue
        cost = -(-pairs * c // sms) * per + (c > 1)
        if best is None or cost < best[0]:
            best = (cost, c)
    chunks = best[1]
    stage = kv8_stage_bytes(hd)
    stages = min(KV8_STAGES, (SMEM_LIMIT - 1024) // stage)
    merge = (splits - 1) * row_tiles * (64 * hd + 512)
    return Kv8Plan(row_tiles, row_blocks, splits, chunks, stages,
                   1024 + max(stages * stage, merge),
                   pairs * chunks)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kv8_decode_attention(q, k8, ks, v8, vs, kv_valid=None):
    """softmax(q k^T * scale) v over the int8 cache -> [B, T, H, hd] in q's
    dtype.  q [B, T, H, hd]; kv_valid [B, S] bool or None."""
    if not q.is_cuda:
        return kv8_decode_attention_reference(q, k8, ks, v8, vs, kv_valid)
    B, T, H, hd = q.shape
    Hkv, S = k8.shape[1], k8.shape[2]
    want = {"k8": (k8, torch.int8, (B, Hkv, S, hd)),
            "v8": (v8, torch.int8, (B, Hkv, S, hd)),
            "ks": (ks, torch.float32, (B, Hkv, 1, S)),
            "vs": (vs, torch.float32, (B, Hkv, 1, S))}
    if kv_valid is not None:
        want["kv_valid"] = (kv_valid, torch.bool, (B, S))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"kv8_decode_attention: {name} must be "
                             f"contiguous {dtype} {shape} on {q.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dtype != torch.bfloat16 or H % Hkv or H // Hkv > KV8_MAX_G \
            or hd % 16 or 256 % hd:
        raise ValueError(f"kv8_decode_attention: q {q.dtype} "
                         f"{tuple(q.shape)} over {Hkv} KV heads")
    q = q.contiguous()
    p = kv8_plan(B, T, H, Hkv, S, hd, _sms(q.device.index))
    out = torch.empty_like(q)
    ws = None
    if p.chunks > 1:   # the chunks' (O, m, l) in f32
        ws = torch.empty(p.units * p.row_tiles * 16 * (hd + 2),
                         dtype=torch.float32, device=q.device)
    kernels.check(kernels.library().lavida_kv8_decode_attention(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), None if kv_valid is None else kv_valid.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), B, T, H, Hkv,
        S, hd, 1.0 / hd ** 0.5, p.row_tiles, p.row_blocks, p.splits,
        p.chunks, p.stages, p.smem,
        torch.cuda.current_stream(q.device).cuda_stream),
        "kv8_decode_attention")
    kv8_decode_attention.launches += 1
    return out


kv8_decode_attention.launches = 0
