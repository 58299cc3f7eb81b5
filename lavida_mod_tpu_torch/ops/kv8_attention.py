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
    masked to -1e30, the whole row softmaxed, p * vs rounded to bf16, the
    PV product in f32, the result in q's dtype.

The kernel's caps (ROADMAP Queue 3, item 1): it softmaxes a whole row of
scores in shared memory, so it takes S <= 6400 cached positions (4 x S x
8 bytes of scores within 200 KB) and a head dim that is a multiple of 16
dividing 256 (16, 32, 64, 128 or 256); the wrapper raises past them.  The JAX kernel holds the whole per-KV-head
cache as one VMEM block with no online softmax either
(lavida_mod_tpu/ops/kv8_attention.py:108-128, "S=1088, hd=128 -> 2x136 KB
int8"); its cap is the v5e's VMEM, not measured.  The paths today stay
near S = 1184; a longer cache needs the row tiled with an online softmax.

The int4 cache (`--kv4`) is not ported: `quantize_kv(bits=4)` raises.
"""

from __future__ import annotations

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
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"kv8_decode_attention: {name} must be "
                             f"contiguous {dtype} {shape}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if q.dtype != torch.bfloat16 or H % Hkv or H // Hkv > 16 or hd % 16 \
            or 256 % hd:
        raise ValueError(f"kv8_decode_attention: q {q.dtype} "
                         f"{tuple(q.shape)} over {Hkv} KV heads")
    if 4 * S * 8 > 200 * 1024:
        raise ValueError(f"kv8_decode_attention: S = {S} exceeds the "
                         f"score block's shared memory")
    q = q.contiguous()
    valid = None
    if kv_valid is not None:
        valid = kv_valid.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    kernels.check(kernels.library().lavida_kv8_decode_attention(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), None if valid is None else valid.data_ptr(),
        out.data_ptr(), B, T, H, Hkv, S, hd, 1.0 / hd ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream),
        "kv8_decode_attention")
    kv8_decode_attention.launches += 1
    return out


kv8_decode_attention.launches = 0
