"""The port's fused SigLIP MLP half-block (lavida_mod_tpu_torch.ops.vit_mlp,
kernel #9) against the JAX package's Pallas `fused_vit_mlp`, which runs in
interpret mode off the TPU (vit_mlp.py:114), at tests/test_vit_mlp.py's
shapes and tolerances (2e-5 in f32, 0.05 in bf16) plus the so400m width
D = 1152 with a narrow F.  Both follow the TPU kernel's order (LN in f32,
per 512-wide F tile fc1 + b1 and the tanh GELU in f32, the tile's fc2
product added to the f32 accumulator in order, x + acc + b2); their dot
products sum in different orders.  The port takes the nn.Linear weight
layouts (w1 [F, D], w2 [D, F]).

The CUDA kernels are held to the plain version by the tests that need a
card (skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_vit_mlp.py
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lavida_mod_tpu.ops.vit_mlp import fused_vit_mlp as jax_vit_mlp
from lavida_mod_tpu_torch.ops import vit_mlp as tv

torch.set_num_threads(2)


def _inputs(seed, N, T, D, F, bf16):
    rng = np.random.default_rng(seed)
    a = dict(x=rng.standard_normal((N, T, D)),
             g=rng.standard_normal(D), b=rng.standard_normal(D),
             w1=rng.standard_normal((D, F)) * 0.05,
             b1=rng.standard_normal(F) * 0.1,
             w2=rng.standard_normal((F, D)) * 0.05,
             b2=rng.standard_normal(D) * 0.1)
    a = {k: v.astype(np.float32) for k, v in a.items()}
    if bf16:      # the serving dtype: values bf16 represents exactly
        a = {k: torch.from_numpy(v).bfloat16().float().numpy()
             for k, v in a.items()}
    return a


def _both(a, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    t = {k: torch.from_numpy(v).to(dt) for k, v in a.items()}
    got = tv.fused_vit_mlp(t["x"], t["g"], t["b"], t["w1"].t().contiguous(),
                           t["b1"], t["w2"].t().contiguous(), t["b2"])
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    j = {k: jnp.asarray(v, jdt) for k, v in a.items()}
    want = jax_vit_mlp(j["x"], j["g"], j["b"], j["w1"], j["b1"], j["w2"],
                       j["b2"])
    assert got.dtype == dt and got.shape == a["x"].shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("N,T,D,F", [
    (2, 64, 256, 640),      # small
    (1, 729, 256, 520),     # so400m token count, F not tile-aligned
    (3, 100, 128, 512),     # M not tile-aligned
])
def test_plain_matches_interpret_kernel_f32(N, T, D, F):
    got, want = _both(_inputs(0, N, T, D, F, False), False)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("N,T,D,F", [(2, 729, 256, 1024), (1, 75, 1152, 520)])
def test_plain_matches_interpret_kernel_bf16(N, T, D, F):
    got, want = _both(_inputs(1, N, T, D, F, True), True)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_cpu_route_counts_no_launch():
    before = tv.fused_vit_mlp.launches
    _both(_inputs(0, 1, 8, 128, 64, True), True)
    assert tv.fused_vit_mlp.launches == before


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_args(g, N, T, D, F):
    """x [N, T, D], gamma, beta, w1 [F, D], b1, w2 [D, F], b2 (bf16 on the
    card, drawn from `g`)."""
    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=g.device)
                * s).bfloat16()

    return (rnd(N, T, D), rnd(D), rnd(D), rnd(F, D, s=0.05), rnd(F, s=0.1),
            rnd(D, F, s=0.05), rnd(D, s=0.1))


def _launch(args, ln, h, out, eps=1e-6):
    """The C entry point on caller-owned buffers: ln [M, D] and h [M, F]
    hold the first two launches' outputs afterwards."""
    from lavida_mod_tpu_torch import kernels

    x, gamma, beta, w1, b1, w2, b2 = args
    D, F = x.shape[-1], w1.shape[0]
    kernels.check(kernels.library().lavida_vit_mlp(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln.data_ptr(),
        h.data_ptr(), out.data_ptr(), x.numel() // D, D, F, eps,
        torch.cuda.current_stream().cuda_stream), "lavida_vit_mlp")


@pytest.mark.parametrize("N,T,D,F", [
    (5, 729, 1152, 4304),   # one image: the batched path's call
    (1, 77, 256, 520),      # ragged M, N and K edges; F % 64 != 0
    (20, 729, 1152, 4304),  # M = 14580: 20 views at once
    (1, 300, 1152, 4304),   # M % 128 != 0 at F = 4304 (fc1's N edge,
                            # fc2's K edge)
    (1, 77, 2304, 520),     # D > 2048: the LN pass's looping path
])
def test_kernel_matches_plain_on_cuda(cuda, N, T, D, F):
    g = torch.Generator(device=cuda).manual_seed(0)
    args = _card_args(g, N, T, D, F)
    before = tv.fused_vit_mlp.launches
    out = tv.fused_vit_mlp(*args)
    torch.cuda.synchronize()
    assert tv.fused_vit_mlp.launches == before + 1
    ref = tv.fused_vit_mlp_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.05, atol=0.05)


def _bf16(device):
    return {"dtype": torch.bfloat16, "device": device}


@pytest.mark.parametrize("M,D,F", [(3645, 1152, 4304), (77, 256, 520)])
def test_each_launch_matches_its_plain_step_on_cuda(cuda, M, D, F):
    """ln against the f32 LayerNorm rounded to bf16; h against fc1 + b1 and
    the tanh GELU in f32 on the kernel's own ln, rounded to bf16; out
    against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(1)
    args = _card_args(g, 1, M, D, F)
    x, gamma, beta, w1, b1, w2, b2 = args
    ln, h = torch.empty(M, D, **_bf16(cuda)), torch.empty(M, F, **_bf16(cuda))
    out = torch.empty(M, D, **_bf16(cuda))
    _launch(args, ln, h, out)
    torch.cuda.synchronize()
    xf = x.reshape(M, D).float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    ln_ref = ((xf - mu) * torch.rsqrt(var + 1e-6) * gamma.float()
              + beta.float()).bfloat16()
    torch.testing.assert_close(ln.float(), ln_ref.float(), rtol=0.05,
                               atol=0.05)
    h_ref = tv._gelu_tanh_f32(ln.float() @ w1.float().t()
                              + b1.float()).bfloat16()
    torch.testing.assert_close(h.float(), h_ref.float(), rtol=0.05,
                               atol=0.05)
    ref = tv.fused_vit_mlp_reference(*args).reshape(M, D)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.05,
                               atol=0.05)


def test_wrapper_refuses_a_misaligned_bias_on_cuda(cuda):
    """The kernels read gamma and beta in 16-byte pieces: a view that
    starts off a 16-byte boundary is refused, not read wrongly."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, gamma, beta, w1, b1, w2, b2 = _card_args(g, 1, 77, 256, 520)
    off = torch.empty(257, dtype=torch.bfloat16, device=cuda)[1:]
    off.copy_(beta)
    with pytest.raises(ValueError, match="beta"):
        tv.fused_vit_mlp(x, gamma, off, w1, b1, w2, b2)


def test_chained_calls_into_the_same_buffers_on_cuda(cuda):
    """20 calls back to back without a sync, each after new data is written
    into the same input buffers, each writing the same ln, h and out (the
    tensor maps are cached by address): every output is that call's."""
    g = torch.Generator(device=cuda).manual_seed(2)
    M, D, F = 3645, 1152, 4304
    bufs = [torch.empty_like(a) for a in _card_args(g, 1, M, D, F)]
    ln, h = torch.empty(M, D, **_bf16(cuda)), torch.empty(M, F, **_bf16(cuda))
    out = torch.empty(M, D, **_bf16(cuda))
    got = []
    for _ in range(20):
        for buf, new in zip(bufs, _card_args(g, 1, M, D, F)):
            buf.copy_(new)
        _launch(bufs, ln, h, out)
        got.append((out.clone(), tv.fused_vit_mlp_reference(*bufs)))
    torch.cuda.synchronize()
    for o, ref in got:
        torch.testing.assert_close(o.float(), ref.reshape(M, D).float(),
                                   rtol=0.05, atol=0.05)


# ---------------------------------------------------------------------------
# the kernel source and the timing script, read on the CPU
# ---------------------------------------------------------------------------

def test_gemm_source_keeps_one_wgmma_and_its_register_contract():
    """The GEMM's bf16 product is hopper.cuh's (one copy in csrc/), its
    producer hands registers over (so the build is held to 168 at entry)
    and its launches run under programmatic dependent launch."""
    import pathlib

    from lavida_mod_tpu_torch import kernels

    csrc = pathlib.Path(kernels.CSRC)
    texts = {p.name: p.read_text() for p in sorted(csrc.glob("*.cu*"))}
    defined = "void wgmma_ss<128>(float (&d)[64]"   # A and B from shared memory
    assert [n for n, t in texts.items() if defined in t] == ["hopper.cuh"]
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in \
        texts["hopper.cuh"]
    src = texts["vit_mlp.cu"]
    assert "wgmma_ss<128>(" in src and "tma_load_2d(" in src
    assert "setmaxnreg.dec.sync.aligned.u32 24;" in src
    assert "setmaxnreg.inc.sync.aligned.u32 240;" in src
    assert kernels.REGISTERS_AT_ENTRY["mlp_gemm_kernel"] == 168
    assert src.count("launch_dependent(mlp_gemm_kernel") == 2   # fc1, fc2
    assert "griddep_wait();" in src


def test_bound_at_the_bench_image():
    """4 M D F flops at 989 TFLOP/s: 73 us per call at M = 3645, 7.60 ms
    per B = 4 batch's 104 calls; the ragged case is bound by its bytes."""
    from lavida_mod_tpu_torch import kernel_times as kt

    assert kt.vit_mlp_bound_ms(3645, 1152, 4304) == pytest.approx(
        4 * 3645 * 1152 * 4304 / 989e12 * 1e3)
    assert kt.vit_mlp_bound_ms(3645, 1152, 4304) * kt.VIT_LAUNCHES == \
        pytest.approx(7.60, abs=0.01)
    nbytes = 4 * 77 * 256 + 4 * 256 * 520 + 2 * (520 + 3 * 256)
    assert kt.vit_mlp_bound_ms(77, 256, 520) == pytest.approx(
        nbytes / 3.35e12 * 1e3)
