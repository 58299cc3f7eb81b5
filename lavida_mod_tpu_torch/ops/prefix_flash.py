"""Prefix-LM flash attention for training: the port of
lavida_mod_tpu/ops/prefix_flash.py (kernel #10, the three Pallas calls
`_fwd_kernel`, `_dq_kernel` and `_dkv_kernel`).

    visible(b, q, kv) = kv_valid[b, kv] & ((kv < plen[b]) | (q >= plen[b]))

over SEQUENCE indices (never the RoPE positions), so a prompt of plen[b]
tokens sees itself bidirectionally and the answer sees everything.

Three entry points, each dispatching on where its tensors lie: CUDA tensors
launch the hand-written Hopper kernels of `csrc/prefix_flash.cu`, CPU
tensors run the plain PyTorch versions beside them.  There is no fallback
from one to the other.
  - `prefix_flash_fwd` -> (o [B, T, Hq, hd], lse [B, Hq, T] f32);
  - `prefix_flash_dq` -> dq;
  - `prefix_flash_dkv` -> (dk, dv), summed over each kv head's query group.
`prefix_flash_attention` is the differentiable op (`_PrefixFlash`, an
autograd Function): its forward saves (q, k, v, plen, kv_valid, o, lse), its
backward computes delta = sum(f32(dO) * f32(o)) over hd as a tensor op and
calls dq and dkv.

Numerics as the TPU kernels: scores in f32 masked with the finite -1e30; p
rounded to v's dtype before the PV product; o = acc / max(l, 1e-30) and
lse = m + log(max(l, 1e-30)); in the backward p = where(visible, exp(s -
lse), 0), ds = p * (dp - delta), dq = scale * bf16(ds) @ k, dv = bf16(p)^T
@ dO, dk = scale * bf16(ds)^T @ q.  The plain versions take one pass over
all keys where the kernels stream tiles (the TPU 512-row blocks, the CUDA
128-key ones): the same function up to rounding.  The TPU wrapper pads T
and S to its block (at T = 1152 to 1536) and masks the pad keys; the CUDA
kernels mask the ragged edges in place.  A row that sees no key at all sums
v over the S real keys and, as the TPU kernel does, divides by the padded
key count (`padded_keys`): the TPU's zero pad keys score -1e30 too and add
one each to its row sum.  No training batch builds such a row; its lse is
-1e30 either way, so the backward is unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _visible(plen: torch.Tensor, kv_valid: torch.Tensor | None, T: int,
             S: int) -> torch.Tensor:
    """[B, 1, 1, T, S] bool, broadcast over [B, Hkv, G, T, S]."""
    dev = plen.device
    qpos = torch.arange(T, device=dev)[None, :, None]
    kpos = torch.arange(S, device=dev)[None, None, :]
    pl = plen.to(torch.int64)[:, None, None]
    ok = (kpos < pl) | (qpos >= pl)
    if kv_valid is not None:
        ok = ok & kv_valid.bool()[:, None, :]
    return ok[:, None, None]


def _grouped(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, T, Hq, hd] -> [B, T, Hkv, G, hd] in f32."""
    B, T, Hq, hd = q.shape
    return q.reshape(B, T, Hkv, Hq // Hkv, hd).float()


def _scores(q, k, scale):
    """f32 scores [B, Hkv, G, T, S] (a bf16 product is exact in f32)."""
    return torch.einsum("bthgd,bshd->bhgts", _grouped(q, k.shape[2]),
                        k.float()) * scale


def padded_keys(S: int) -> int:
    """The key count the TPU wrapper pads S to: a multiple of its key block
    min(512, S rounded up to 128) (prefix_flash.py:349-360)."""
    bk = min(512, -(-S // 128) * 128)
    return -(-S // bk) * bk


def prefix_flash_fwd_reference(q, k, v, plen, kv_valid=None, scale=None):
    """Plain version of the forward: (o [B, T, Hq, hd] in q's dtype, lse
    [B, Hq, T] f32)."""
    B, T, Hq, hd = q.shape
    S = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    s = torch.where(_visible(plen, kv_valid, T, S), _scores(q, k, scale),
                    NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(m <= NEG_INF, l + (padded_keys(S) - S), l).clamp(min=1e-30)
    o = torch.einsum("bhgts,bshd->bhgtd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, T)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, hd).to(q.dtype), lse


def _backward_terms(q, k, v, plen, kv_valid, dout, lse, delta, scale):
    """(p, ds) [B, Hkv, G, T, S] f32 of the backward kernels."""
    B, T, Hq, hd = q.shape
    Hkv, S = k.shape[2], k.shape[1]
    G = Hq // Hkv
    s = _scores(q, k, scale)
    p = torch.where(_visible(plen, kv_valid, T, S),
                    torch.exp(s - lse.reshape(B, Hkv, G, T, 1)), 0.0)
    dp = torch.einsum("bthgd,bshd->bhgts",
                      _grouped(dout.to(v.dtype), Hkv), v.float())
    ds = p * (dp - delta.reshape(B, Hkv, G, T, 1))
    return p, ds


def prefix_flash_dq_reference(q, k, v, plen, kv_valid, dout, lse, delta,
                              scale=None):
    """Plain version of the dq kernel: dq [B, T, Hq, hd] in q's dtype."""
    B, T, Hq, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    _, ds = _backward_terms(q, k, v, plen, kv_valid, dout, lse, delta, scale)
    dq = scale * torch.einsum("bhgts,bshd->bthgd", ds.to(k.dtype).float(),
                              k.float())
    return dq.reshape(B, T, Hq, hd).to(q.dtype)


def prefix_flash_dkv_reference(q, k, v, plen, kv_valid, dout, lse, delta,
                               scale=None):
    """Plain version of the dkv kernel: (dk, dv) [B, S, Hkv, hd] in k's and
    v's dtypes, each summed over the kv head's query group."""
    hd = q.shape[3]
    Hkv = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    p, ds = _backward_terms(q, k, v, plen, kv_valid, dout, lse, delta, scale)
    dv = torch.einsum("bhgts,bthgd->bshd", p.to(dout.dtype).float(),
                      _grouped(dout, Hkv))
    dk = scale * torch.einsum("bhgts,bthgd->bshd", ds.to(q.dtype).float(),
                              _grouped(q, Hkv))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda_args(name, q, k, v, plen, kv_valid, *rest):
    B, T, Hq, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd or Hq % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if hd % 8 or hd > 128:
        raise ValueError(f"{name}: head dim {hd} must be a multiple of 8 "
                         f"and at most 128")
    S = k.shape[1]
    for nm, t, dtype, shape in (
            ("q", q, torch.bfloat16, None), ("k", k, torch.bfloat16, None),
            ("v", v, torch.bfloat16, None), ("plen", plen, torch.int32, (B,)),
            ("kv_valid", kv_valid, torch.int32, (B, S)), *rest):
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {nm} must be contiguous, 16-byte aligned {dtype}"
                f"{'' if shape is None else f' {shape}'} on {q.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _all_valid_if_none(kv_valid, k):
    """kv_valid, or [B, S] int32 ones (every key valid) when it is None."""
    if kv_valid is None:
        return torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
    return kv_valid


def _launch_args(q, k):
    B, T, Hq, hd = q.shape
    return (B, T, k.shape[1], Hq, k.shape[2], hd)


def prefix_flash_fwd(q, k, v, plen, kv_valid=None, scale=None):
    """(o, lse) of prefix-LM attention.  q [B, T, Hq, hd]; k, v [B, S, Hkv,
    hd]; plen [B] int; kv_valid [B, S] bool/int or None.  CUDA: bf16, hd a
    multiple of 8 up to 128; plen and kv_valid int32."""
    hd = q.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    if not q.is_cuda:
        return prefix_flash_fwd_reference(q, k, v, plen, kv_valid, scale)
    kv_valid = _all_valid_if_none(kv_valid, k)
    _check_cuda_args("prefix_flash_fwd", q, k, v, plen, kv_valid)
    B, T, Hq = q.shape[:3]
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    err = kernels.library().lavida_prefix_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), plen.data_ptr(),
        kv_valid.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_launch_args(q, k), ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "prefix_flash_fwd")
    prefix_flash_fwd.launches += 1
    return o, lse


def _grad_args(q, dout, lse, delta):
    B, T, Hq = q.shape[:3]
    return (("dout", dout, torch.bfloat16, tuple(q.shape)),
            ("lse", lse, torch.float32, (B, Hq, T)),
            ("delta", delta, torch.float32, (B, Hq, T)))


def prefix_flash_dq(q, k, v, plen, kv_valid, dout, lse, delta, scale=None):
    """dq of prefix-LM attention from dO, the forward's lse and delta [B,
    Hq, T] f32; kv_valid [B, S] or None as in `prefix_flash_fwd`."""
    hd = q.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    if not q.is_cuda:
        return prefix_flash_dq_reference(q, k, v, plen, kv_valid, dout, lse,
                                         delta, scale)
    kv_valid = _all_valid_if_none(kv_valid, k)
    _check_cuda_args("prefix_flash_dq", q, k, v, plen, kv_valid,
                     *_grad_args(q, dout, lse, delta))
    dq = torch.empty_like(q)
    err = kernels.library().lavida_prefix_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), plen.data_ptr(),
        kv_valid.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_launch_args(q, k),
        ctypes.c_float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "prefix_flash_dq")
    prefix_flash_dq.launches += 1
    return dq


def prefix_flash_dkv(q, k, v, plen, kv_valid, dout, lse, delta, scale=None):
    """(dk, dv) of prefix-LM attention, each kv head summed over its query
    group; kv_valid [B, S] or None as in `prefix_flash_fwd`."""
    hd = q.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    if not q.is_cuda:
        return prefix_flash_dkv_reference(q, k, v, plen, kv_valid, dout, lse,
                                          delta, scale)
    kv_valid = _all_valid_if_none(kv_valid, k)
    _check_cuda_args("prefix_flash_dkv", q, k, v, plen, kv_valid,
                     *_grad_args(q, dout, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = kernels.library().lavida_prefix_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), plen.data_ptr(),
        kv_valid.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_launch_args(q, k),
        ctypes.c_float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "prefix_flash_dkv")
    prefix_flash_dkv.launches += 1
    return dk, dv


prefix_flash_fwd.launches = 0
prefix_flash_dq.launches = 0
prefix_flash_dkv.launches = 0


def attention_delta(dout: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = sum(f32(dO) * f32(o)) over hd, [B, Hq, T] f32
    (prefix_flash.py:226)."""
    return (dout.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


class _PrefixFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, plen, kv_valid, scale):
        o, lse = prefix_flash_fwd(q, k, v, plen, kv_valid, scale)
        ctx.save_for_backward(q, k, v, plen, kv_valid, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, plen, kv_valid, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(dout, o)
        args = (q, k, v, plen, kv_valid, dout, lse, delta, ctx.scale)
        dq = prefix_flash_dq(*args)
        dk, dv = prefix_flash_dkv(*args)
        return dq, dk, dv, None, None, None


def prefix_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prefix_lengths: torch.Tensor,
    kv_valid: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Differentiable prefix-LM attention; shapes as `dense_attention`:
    q [B, T, Hq, hd], k, v [B, S, Hkv, hd], prefix_lengths [B] (0 = fully
    bidirectional), kv_valid [B, S] bool or None.  Returns [B, T, Hq, hd]
    in q's dtype."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    plen = prefix_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    kv_valid = _all_valid_if_none(kv_valid, k).to(
        device=q.device, dtype=torch.int32).contiguous()
    return _PrefixFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              plen, kv_valid, scale)
