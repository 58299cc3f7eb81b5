"""Decode attention over the bf16 KV cache, read where it lies: the
attention of the cached denoise step (`LLaDA.forward` with
`kv_write_index`, a bf16 (k, v) cache, not causal, no prefix-LM mask).

The JAX package's denoise step attends over the bf16 cache in plain XLA
(or through its short-attention kernel with `use_flash`), and this port
ran `ops/attention.py::dense_attention` there.  Its batched products take
K and V with the (batch, KV head) dims folded into one stride, which the
[B, S, Hkv, hd] cache buffers do not have, so every layer of every step
copied the whole cache.  `decode_attention` computes the same function
without that copy:

  - CUDA tensors launch the kernel of csrc/decode_attention.cu: 64-key K/V
    tiles streamed by TMA straight from the buffers, the G T query rows of
    each (batch row, KV head) in 64-row wgmma tiles, an online softmax,
    and key splits merged by a second kernel where the (batch row, KV
    head) pairs do not fill the card (`decode_plan`).  Each launch counts
    in `decode_attention.launches`.
  - CPU tensors run `decode_attention_reference`, the plain version
    (`short_attention_reference` under segment ids).

Semantics (dense_attention's with an additive mask from `kv_valid`): head
h reads KV head h // G; scores and softmax in f32; a key whose valid byte
is 0 scores the finite -1e30, so a row that sees no key averages over all
S keys.  As kernel #1, the unnormalized p = exp(s - max) is cast to v's
dtype for the PV product, which accumulates in f32 and is divided by the
row sum; the output has q's dtype.  dense_attention rounds the normalized
p instead: the two agree to bf16's rounding of p, exactly in f32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import kernels
from .short_attention import short_attention_reference

# The kernel's plan (csrc/decode_attention.cu mirrors each constant and
# refuses a plan that does not match): a CTA is (64-row query tile, key
# split, batch row, KV head); a ring stage holds DEC_KEYS keys of K and V;
# DEC_CTAS_PER_SM CTAs share an SM (the three-stage ring of 32 KB stages
# at hd 128 allows two).
DEC_ROWS = 64
DEC_KEYS = 64
DEC_STAGES = 3
DEC_MAX_SPLITS = 32
DEC_CTAS_PER_SM = 2
# the head dims the kernel is built for: LLaDA-8B's and Dream-7B's, and the
# tiny test models'; LLaDA.forward routes no other to it
DEC_HEAD_DIMS = (16, 128)


class DecodePlan(NamedTuple):
    row_tiles: int    # 64-row tiles of the G T query rows of a KV head
    splits: int       # key splits (merged in split order when > 1)
    per_split: int    # key tiles per split
    ctas: int         # B x Hkv x row_tiles x splits


@functools.lru_cache(maxsize=64)   # called per layer per step: a few shapes
def decode_plan(B: int, T: int, Hq: int, Hkv: int, S: int, hd: int,
                sms: int) -> DecodePlan:
    """The kernel's layout for q [B, T, Hq, hd] over S keys on a card of
    `sms` SMs.  The key tiles are cut into the splits that let the most
    loaded CTA slot stream the fewest tiles, counting a CTA's start (its
    Q load and the ring's first fill) as one tile more and the merge of
    more than one split as a tile; ties go to fewer splits.  At the
    batched serving step (1024 (batch row, KV head) pairs, four CTAs a
    slot) that is no split; at B = 1 (32 pairs) six."""
    if B < 1 or T < 1 or S < 1 or Hkv < 1 or Hq % Hkv \
            or hd not in DEC_HEAD_DIMS or B * Hkv > 65535:
        raise ValueError(f"decode_plan: B {B} T {T} Hq {Hq} Hkv {Hkv} S {S}"
                         f" hd {hd}")
    row_tiles = -(-(Hq // Hkv * T) // DEC_ROWS)
    tiles = -(-S // DEC_KEYS)
    units = B * Hkv * row_tiles
    slots = DEC_CTAS_PER_SM * sms
    best = None
    for c in range(1, min(tiles, DEC_MAX_SPLITS) + 1):
        per = -(-tiles // c)
        if (c - 1) * per >= tiles:      # a split would be empty
            continue
        cost = -(-units * c // slots) * (per + 1) + (c > 1)
        if best is None or cost < best[0]:
            best = (cost, c, per)
    _, splits, per = best
    return DecodePlan(row_tiles, splits, per, units * splits)


def decode_attention_reference(q, k, v, kv_valid=None):
    """Plain version: `short_attention_reference` under segment ids (1 for
    every query, the valid byte for every key), the unsplit softmax.  q
    [B, T, Hq, hd]; k, v [B, S, Hkv, hd]; kv_valid [B, S] bool or None.
    A batch row that sees no key takes uniform weights over its S keys
    (dense_attention's additive mask): its queries are zeroed and its keys
    all counted, as short_attention_reference would otherwise also count
    the TPU kernel's padded keys.  Returns [B, T, Hq, hd] in q's dtype."""
    if kv_valid is None:
        return short_attention_reference(q, k, v)
    B, T = q.shape[:2]
    sees = kv_valid.any(dim=1)
    q = torch.where(sees[:, None, None, None], q, torch.zeros_like(q))
    seg_kv = (kv_valid | ~sees[:, None]).to(torch.int32)
    seg_q = torch.ones(B, T, dtype=torch.int32, device=q.device)
    return short_attention_reference(q, k, v, seg_q, seg_kv)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k, v, kv_valid=None):
    """softmax(q k^T * scale, masked) v over the cache buffers -> [B, T,
    Hq, hd] in q's dtype.  q [B, T, Hq, hd]; k, v [B, S, Hkv, hd]; kv_valid
    [B, S] bool or None.  CUDA: bf16, k and v contiguous, hd one of
    DEC_HEAD_DIMS."""
    if not q.is_cuda:
        return decode_attention_reference(q, k, v, kv_valid)
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    want = {"k": (k, torch.bfloat16, (B, S, Hkv, hd)),
            "v": (v, torch.bfloat16, (B, S, Hkv, hd))}
    if kv_valid is not None:
        want["kv_valid"] = (kv_valid, torch.bool, (B, S))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != q.device \
                or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"{dtype} {shape} on {q.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention: q is {q.dtype}, the kernel "
                         f"takes bfloat16")
    p = decode_plan(B, T, Hq, Hkv, S, hd, _sms(q.device.index))
    q = q.contiguous()
    out = torch.empty_like(q)
    ws = None
    if p.splits > 1:   # each split's O, then its (m, l), in f32
        ws = torch.empty(p.ctas * DEC_ROWS * (hd + 2), dtype=torch.float32,
                         device=q.device)
    kernels.check(kernels.library().lavida_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, T, Hq, Hkv, S, hd,
        1.0 / hd ** 0.5, p.row_tiles, p.splits,
        torch.cuda.current_stream(q.device).cuda_stream), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
