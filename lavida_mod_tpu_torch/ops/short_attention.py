"""Non-causal GQA attention with segment-id masking: the port of
lavida_mod_tpu/ops/short_attention.py.

`short_attention` dispatches on where its tensors lie.  CUDA tensors launch
the hand-written Hopper kernel in `csrc/short_attention.cu` (online softmax
over streamed K/V tiles, so every S is served, with no 4096 cap); CPU
tensors run `short_attention_reference`, the plain PyTorch version of the
same function.  There is no fallback from one to the other.

Semantics (as the TPU kernel): head h reads K/V head h // G; a key is
masked with the finite -1e30 when its segment id differs from the query's;
scores and softmax are f32; the unnormalized p = exp(s - max) is cast to
v's dtype before the PV product, which accumulates in f32 and is divided
by the row sum; the output has q's dtype.  The TPU wrapper pads
T and S to 128 with pad segments -1/-2; here the ragged edges are masked
in the kernel instead.  A query row that matches no key of its segment
sums v over the S real keys and, as the TPU kernel does, divides by the
padded key count ceil(S / 128) * 128: the TPU's zero pad keys score -1e30
too and add one each to its row sum.  The main path never builds such a
row.

Differentiable (`_ShortAttention`, an autograd Function, the counterpart of
the TPU kernel's custom VJP): the backward recomputes through
`short_attention_reference` and takes its VJP with torch autograd, as
`_short_bwd` (short_attention.py:163-170) takes the VJP of its plain twin
`_short_reference` with jax.vjp.  The two plain functions are one function
in f32; in bf16 JAX's rounds the normalized p, this one the unnormalized p
as the kernels do.  That backward is plain tensor math on both packages,
not a kernel; `short_attention.backward_calls` counts it.  The SigLIP
tower of stage-2 training runs it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

NEG_INF = -1e30


def short_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version.  q [B, T, Hq, hd]; k, v [B, S, Hkv, hd];
    segment ids [B, T] / [B, S] or None.  Returns [B, T, Hq, hd]."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, hd).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * (1.0 / hd ** 0.5)
    if segment_ids_q is not None:
        ok = (segment_ids_q[:, None, None, :, None]
              == segment_ids_kv[:, None, None, None, :])
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    # the TPU kernel's order: unnormalized p rounded to v's dtype for the
    # PV product, the row sum applied after it
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgts,bshd->bhgtd", p.to(v.dtype).float(), v.float())
    l = p.sum(dim=-1, keepdim=True)
    if segment_ids_q is not None:   # a row that sees no key: + the pad keys
        S = k.shape[1]
        l = torch.where(m <= NEG_INF, l + (-(-S // 128) * 128 - S), l)
    o = o / l
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, hd).to(q.dtype)


def _check_cuda_args(q, k, v, segment_ids_q, segment_ids_kv):
    B, T, Hq, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"short_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % k.shape[2] != 0:
        raise ValueError(f"short_attention: {Hq} q heads over "
                         f"{k.shape[2]} kv heads")
    if hd % 8 != 0 or hd > 128:
        raise ValueError(f"short_attention: head dim {hd} must be a "
                         f"multiple of 8 and at most 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"short_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"short_attention: {name} is {t.dtype}; the "
                            f"CUDA kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"short_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if (segment_ids_q is None) != (segment_ids_kv is None):
        raise ValueError("short_attention: give both segment id arrays "
                         "or neither")
    if segment_ids_q is not None:
        S = k.shape[1]
        for name, t, shape in (("segment_ids_q", segment_ids_q, (B, T)),
                               ("segment_ids_kv", segment_ids_kv, (B, S))):
            if t.device != q.device or t.dtype != torch.int32 \
                    or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"short_attention: {name} must be contiguous int32 "
                    f"{shape} on {q.device}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")


def _forward(q, k, v, segment_ids_q, segment_ids_kv):
    if not q.is_cuda:
        return short_attention_reference(q, k, v, segment_ids_q,
                                         segment_ids_kv)
    _check_cuda_args(q, k, v, segment_ids_q, segment_ids_kv)
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    masked = segment_ids_q is not None
    err = kernels.library().lavida_short_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        segment_ids_q.data_ptr() if masked else None,
        segment_ids_kv.data_ptr() if masked else None, out.data_ptr(),
        B, T, S, Hq, Hkv, hd, ctypes.c_float(1.0 / hd ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "short_attention")
    short_attention.launches += 1
    return out


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids_q, segment_ids_kv):
        ctx.save_for_backward(q, k, v, segment_ids_q, segment_ids_kv)
        return _forward(q, k, v, segment_ids_q, segment_ids_kv)

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg_q, seg_kv = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = short_attention_reference(*leaves, seg_q, seg_kv)
            dq, dk, dv = torch.autograd.grad(o, leaves, g)
        short_attention.backward_calls += 1
        return dq, dk, dv, None, None


def short_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of q [B, T, Hq, hd] over k, v [B, S, Hkv, hd] (GQA when
    Hq > Hkv), masked by segment-id equality when both id arrays
    ([B, T] / [B, S] int32) are given.  CUDA: bf16, contiguous, hd a
    multiple of 8 up to 128.  Returns [B, T, Hq, hd] in q's dtype;
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _ShortAttention.apply(q, k, v, segment_ids_q, segment_ids_kv)
    # nothing to differentiate (serving): the same forward without the
    # autograd Function's per-call host cost
    return _forward(q, k, v, segment_ids_q, segment_ids_kv)


short_attention.launches = 0
short_attention.backward_calls = 0
