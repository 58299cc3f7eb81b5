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


@pytest.mark.parametrize("N,T,D,F", [(5, 729, 1152, 4304), (1, 77, 256, 520)])
def test_kernel_matches_plain_on_cuda(cuda, N, T, D, F):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s).bfloat16()

    args = (rnd(N, T, D), rnd(D), rnd(D), rnd(F, D, s=0.05), rnd(F, s=0.1),
            rnd(D, F, s=0.05), rnd(D, s=0.1))
    before = tv.fused_vit_mlp.launches
    out = tv.fused_vit_mlp(*args)
    torch.cuda.synchronize()
    assert tv.fused_vit_mlp.launches == before + 1
    ref = tv.fused_vit_mlp_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.05, atol=0.05)
