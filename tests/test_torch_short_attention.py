"""The port's short-attention op (lavida_mod_tpu_torch.ops.short_attention)
against the JAX package's Pallas kernel run in interpret mode on the CPU.

On a CPU tensor the port's wrapper runs its plain PyTorch version, which
is what these tests hold to `short_attention(..., interpret=True)` at the
tolerance of tests/test_short_attention.py (atol = rtol = 2e-5, f32).  The
CUDA kernel itself is checked against the plain version by the test that
needs a card (skipped without one) and by chip_smoke.py.

jax is imported only by the tests that compare with it, so the CUDA
tests also run on a GPU machine without jax (or with jax on the GPU, where
its TF32 default precision would not meet the CPU tolerance):
    python -m pytest --noconftest -k cuda tests/test_torch_short_attention.py
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.ops import attention as tattn
from lavida_mod_tpu_torch.ops.short_attention import (
    short_attention, short_attention_reference)

torch.set_num_threads(2)


def _inputs(seed, B, T, S, Hq, Hkv, hd, masked):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    q_seg = kv_seg = None
    if masked:
        q_seg = rng.integers(0, 2, (B, T)).astype(np.int32)
        kv_seg = rng.integers(0, 2, (B, S)).astype(np.int32)
        # every query keeps a key of its own segment (no all-masked row)
        kv_seg[:, 0], kv_seg[:, 1] = 1, 0
        if masked == "blind":   # but every 7th, whose segment no key carries
            q_seg[:, ::7] = 2
    return q, k, v, q_seg, kv_seg


def _both(q, k, v, q_seg, kv_seg):
    jnp = pytest.importorskip("jax.numpy")
    from lavida_mod_tpu.ops.short_attention import short_attention as j_short

    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    out_t = short_attention(t(q), t(k), t(v), t(q_seg), t(kv_seg))
    out_j = j_short(j(q), j(k), j(v), j(q_seg), j(kv_seg), interpret=True)
    return out_t.numpy(), np.asarray(out_j)


@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,masked", [
    (1, 128, 128, 4, 4, 64, False),     # MHA
    (2, 128, 256, 4, 2, 64, False),     # GQA, S != T
    (1, 130, 200, 2, 2, 64, False),     # ragged, not multiples of 128
    (1, 100, 150, 4, 2, 64, True),      # ragged + GQA + segment ids
    (2, 128, 256, 4, 4, 64, True),      # segment ids
    (2, 60, 60, 4, 4, 72, False),       # SigLIP so400m head dim
    (1, 50, 70, 4, 2, 128, True),       # LLaDA head dim
])
def test_plain_matches_jax_kernel(B, T, S, Hq, Hkv, hd, masked):
    out_t, out_j = _both(*_inputs(0, B, T, S, Hq, Hkv, hd, masked))
    np.testing.assert_allclose(out_t, out_j, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd", [
    (1, 100, 150, 4, 2, 64),            # S padded to 256 by the TPU wrapper
    (2, 60, 128, 4, 4, 72),             # S a multiple of 128: no pad keys
    (1, 130, 300, 2, 1, 128),           # T and S padded, G = 2
])
def test_row_that_sees_no_key_matches_jax_kernel(B, T, S, Hq, Hkv, hd):
    """A query whose segment no key carries: every key scores -1e30, so
    the row sums v over the S keys and divides by the padded key count
    (the TPU wrapper's zero pad keys add one each to the row sum)."""
    q, k, v, q_seg, kv_seg = _inputs(6, B, T, S, Hq, Hkv, hd, "blind")
    out_t, out_j = _both(q, k, v, q_seg, kv_seg)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5, rtol=2e-5)
    Sp = -(-S // 128) * 128
    blind = out_t[:, ::7]                              # [B, rows, Hq, hd]
    want = np.repeat(v.sum(1) / Sp, Hq // Hkv, axis=1)[:, None]
    np.testing.assert_allclose(blind, np.broadcast_to(want, blind.shape),
                               atol=2e-6, rtol=2e-6)


def test_padding_mask_like_prefill():
    """The prefill's masks: every query valid, keys valid up to P of a
    [P + G] buffer (the filled-rows mask)."""
    q, k, v, _, _ = _inputs(1, 1, 37, 53, 4, 2, 16, False)
    q_seg = np.ones((1, 37), np.int32)
    kv_seg = (np.arange(53) < 37)[None].astype(np.int32)
    out_t, out_j = _both(q, k, v, q_seg, kv_seg)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5, rtol=2e-5)


def test_cpu_routes_do_not_launch_the_kernel():
    q, k, v, q_seg, kv_seg = (torch.from_numpy(a) for a in
                              _inputs(2, 1, 9, 11, 2, 1, 8, True))
    before = short_attention.launches
    ref = short_attention_reference(q, k, v, q_seg, kv_seg)
    assert torch.equal(tattn.flash_attention(q, k, v, q_seg, kv_seg), ref)
    assert torch.equal(tattn.vision_attention(q, k, v),
                       short_attention_reference(q, k, v))
    assert short_attention.launches == before


@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,masked", [
    (1, 100, 150, 4, 2, 64, True),      # ragged + GQA + segment ids
    (2, 60, 60, 4, 4, 72, False),       # SigLIP so400m head dim
    (1, 100, 150, 4, 2, 64, "blind"),   # rows that see no key
])
def test_vjp_matches_jax_custom_vjp(B, T, S, Hq, Hkv, hd, masked):
    """The autograd Function's backward against jax.vjp of the TPU op,
    whose custom VJP (`_short_bwd`) differentiates `_short_reference`; the
    forward runs the interpret kernel.  f32, the same function on both
    sides: within 1e-5."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from lavida_mod_tpu.ops.short_attention import short_attention as j_short

    q, k, v, q_seg, kv_seg = _inputs(3, B, T, S, Hq, Hkv, hd, masked)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    _, vjp = jax.vjp(lambda q, k, v: j_short(q, k, v, j(q_seg), j(kv_seg),
                                             interpret=True),
                     j(q), j(k), j(v))
    ref = vjp(j(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    before = short_attention.backward_calls
    short_attention(*leaves, t(q_seg), t(kv_seg)).backward(torch.from_numpy(g))
    assert short_attention.backward_calls == before + 1
    for name, leaf, r in zip("qkv", leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


def test_no_grad_call_skips_the_autograd_function():
    """Serving calls (nothing requires grad) take the forward directly; a
    call with a leaf that requires grad goes through the Function."""
    q, k, v, q_seg, kv_seg = (torch.from_numpy(a) for a in
                              _inputs(5, 1, 9, 11, 2, 1, 8, True))
    ref = short_attention_reference(q, k, v, q_seg, kv_seg)
    out = short_attention(q, k, v, q_seg, kv_seg)
    assert out.grad_fn is None and torch.equal(out, ref)
    q.requires_grad_()
    with torch.no_grad():
        assert short_attention(q, k, v, q_seg, kv_seg).grad_fn is None
    out = short_attention(q, k, v, q_seg, kv_seg)
    assert out.grad_fn is not None and torch.equal(out.detach(), ref)


def _ptxas_log(regs, prefix_regs=(168, 168, 168), prefill_regs=(168,),
               mlp_regs=(168, 168)):
    """A build log in ptxas -v's format: one short_attention instance per
    register count in `regs`, between two other kernels, then one instance
    of each prefix_flash kernel (fwd, dq, dkv) with `prefix_regs`, one
    w4_matmul_grouped prefill kernel per count in `prefill_regs` and one
    fused_vit_mlp GEMM instance (fc1, fc2) per count in `mlp_regs`."""
    lines = ["== short_attention.cu",
             "ptxas info    : Compiling entry function '_Z5otherv' for "
             "'sm_90a'", "ptxas info    : Used 96 registers, used 1 "
             "barriers"]

    def instance(name, n):
        return [f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads",
                f"ptxas info    : Used {n} registers, used 16 barriers"]

    for hdp, n in zip((128, 72, 16), regs):
        lines += instance(
            f"_ZN12_GLOBAL__N_122short_attention_kernelILi{hdp}EEEv", n)
    lines += ["ptxas info    : Compiling entry function '_Z5afterv' for "
              "'sm_90a'", "ptxas info    : Used 40 registers",
              "== prefix_flash.cu"]
    for kind, n in zip(("fwd", "dq", "dkv"), prefix_regs):
        name = f"prefix_flash_{kind}_kernel"
        lines += instance(f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi128EEEv", n)
    lines.append("== w4_grouped.cu")
    for n in prefill_regs:
        lines += instance("_ZN12_GLOBAL__N_117w4_prefill_kernelE14CUtensorMap_st", n)
    lines.append("== vit_mlp.cu")
    for epi, n in enumerate(mlp_regs):
        lines += instance(f"_ZN12_GLOBAL__N_115mlp_gemm_kernelILi{epi}EEEv14"
                          f"CUtensorMap_stS1_PK13__nv_bfloat16S4_PS2_iii", n)
    return "\n".join(lines)


@pytest.mark.parametrize("regs,ok", [
    ((168, 168, 168), True),
    ((168, 165, 168), False),   # setmaxnreg.inc 240 would wait for ever
    ((), False),                # no instance found: a renamed kernel
])
def test_register_check_of_the_build_log(regs, ok):
    from lavida_mod_tpu_torch import kernels

    if ok:
        kernels.check_registers(_ptxas_log(regs))
    else:
        with pytest.raises(RuntimeError, match="short_attention_kernel"):
            kernels.check_registers(_ptxas_log(regs))


@pytest.mark.parametrize("prefix_regs,name", [
    ((168, 168, 160), "prefix_flash_dkv_kernel"),
    ((168,), "prefix_flash_dq_kernel"),   # no dq instance in the log
])
def test_register_check_covers_prefix_flash_kernels(prefix_regs, name):
    """The three prefix_flash kernels hand registers over with setmaxnreg
    too: each must be in the log, at 168 registers."""
    from lavida_mod_tpu_torch import kernels

    with pytest.raises(RuntimeError, match=name):
        kernels.check_registers(_ptxas_log((168, 168, 168), prefix_regs))


@pytest.mark.parametrize("prefill_regs", [(160,), ()])
def test_register_check_covers_the_w4_prefill_kernel(prefill_regs):
    """w4_matmul_grouped's prefill kernel hands its producer's registers
    over with setmaxnreg as well: it must be in the log, at 168."""
    from lavida_mod_tpu_torch import kernels

    with pytest.raises(RuntimeError, match="w4_prefill_kernel"):
        kernels.check_registers(_ptxas_log((168, 168, 168),
                                           prefill_regs=prefill_regs))


@pytest.mark.parametrize("mlp_regs", [(168, 160), (160, 168), ()])
def test_register_check_covers_the_vit_mlp_gemm(mlp_regs):
    """fused_vit_mlp's GEMM (its fc1 and fc2 instances) hands its
    producer's registers over with setmaxnreg too: it must be in the log,
    at 168 in every instance."""
    from lavida_mod_tpu_torch import kernels

    with pytest.raises(RuntimeError, match="mlp_gemm_kernel"):
        kernels.check_registers(_ptxas_log((168, 168, 168), mlp_regs=mlp_regs))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _segments(kind, B, T, S, device):
    """None; "pad": keys valid up to T, the last 3 rows match no key (a
    finite average over the S keys); "late": every query's first 260 keys
    (two whole 128-key tiles and more) are masked, and every 5th query sees
    only those (its visible keys all come first)."""
    if kind is None:
        return None, None
    q_seg = torch.ones(B, T, dtype=torch.int32, device=device)
    if kind == "pad":
        kv_seg = (torch.arange(S, device=device) < T).int()
        q_seg[:, -3:] = 2
    else:
        kv_seg = (torch.arange(S, device=device) >= 260).int()
        q_seg[:, ::5] = 0
    return q_seg, kv_seg[None].expand(B, -1).contiguous()


def test_row_that_sees_no_key_on_cuda(cuda):
    """Rows whose segment no key carries: the kernel sums v over the S
    keys and divides by the padded count ceil(S / 128) * 128, as the plain
    version (and the TPU kernel) does; the other rows are unchanged."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, T, S, Hq, Hkv, hd = 2, 150, 300, 8, 2, 128
    q = torch.randn(B, T, Hq, hd, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, Hkv, hd, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    q_seg[:, ::7] = 2
    kv_seg = torch.ones(B, S, dtype=torch.int32, device=cuda)
    out = short_attention(q, k, v, q_seg, kv_seg)
    ref = short_attention_reference(q, k, v, q_seg, kv_seg)
    torch.testing.assert_close(out.float(), ref.float(), atol=8e-3,
                               rtol=8e-3)
    want = (v.float().sum(1) / 384).repeat_interleave(Hq // Hkv, 1)
    torch.testing.assert_close(out[:, ::7].float(),
                               want[:, None].expand(B, len(range(0, T, 7)),
                                                    Hq, hd),
                               atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,kind", [
    (5, 729, 729, 16, 16, 72, None),    # SigLIP layer
    (1, 1056, 1088, 32, 32, 128, "pad"),  # LLaDA prefill
    (2, 77, 131, 8, 2, 64, "pad"),      # GQA, odd lengths
    (1, 65, 63, 4, 2, 72, "pad"),       # hd 72, S < T
    (1, 37, 1, 4, 4, 64, None),         # S = 1
    (1, 37, 1, 4, 1, 128, "pad"),       # S = 1, G = 4, rows with no key
    (2, 50, 50, 4, 4, 16, None),        # hd 16, S shorter than one tile
    (1, 64, 64, 2, 2, 32, None),        # hd 32
    (2, 65, 129, 14, 2, 48, None),      # hd 48, G = 7, S = a tile + 1
    (1, 200, 257, 7, 1, 80, "pad"),     # hd 80, G = 7, S = two tiles + 1
    (1, 130, 300, 8, 2, 72, "late"),    # hd 72, G = 4, leading tiles masked
    (1, 70, 90, 2, 1, 96, "pad"),       # hd 96
    (1, 33, 520, 4, 1, 112, "late"),    # hd 112, G = 4
    (1, 129, 300, 4, 4, 128, "late"),   # hd 128, G = 1
])
def test_kernel_matches_plain_on_cuda(cuda, B, T, S, Hq, Hkv, hd, kind):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, T, Hq, hd, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, Hkv, hd, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    q_seg, kv_seg = _segments(kind, B, T, S, cuda)
    for i in range(2):
        if i:   # new data at the same addresses: the tensor maps the
            # wrapper reuses for them hold addresses, never data
            for t in (q, k, v):
                t.copy_(torch.randn(t.shape, generator=g, device=cuda))
        ref = short_attention_reference(q, k, v, q_seg, kv_seg)
        assert torch.isfinite(ref).all()
        before = short_attention.launches
        out = short_attention(q, k, v, q_seg, kv_seg)
        torch.cuda.synchronize()
        assert short_attention.launches == before + 1
        # p is rounded to bf16 per streamed tile, and the online rescaling
        # sums in another order than the single-pass plain version: read
        # on an H100 within 1.95e-3 - 3.9e-3 (one bf16 ulp of |o| < 1)
        torch.testing.assert_close(out.float(), ref.float(), atol=8e-3,
                                   rtol=8e-3)
