"""The port's per-channel int4 matmul (lavida_mod_tpu_torch.ops.w4_matmul,
kernel #11) against the JAX package's Pallas `w4_matmul` run in interpret
mode on the CPU, as tests/test_pallas_w4.py runs it.

Both take two f32 products of bf16 activations and exactly converted
nibbles and add them; the BLAS of each side sums the terms of a dot in its
own order.  So the tolerance is one bf16 rounding: every element within one
bf16 ulp of the other side's, plus the bound on two f32 orders of the same
sum (2 K u sum|x w| * scale, u = 2^-24), which only matters for an output
that nearly cancels.  The CUDA kernel is held to the plain version the same
way by the tests that need a card (skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_w4_matmul.py
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.ops import quant as tq
from lavida_mod_tpu_torch.ops import w4_matmul as t4

torch.set_num_threads(2)


def _inputs(seed, T, K, N):
    rng = np.random.default_rng(seed)
    w = rng.integers(-8, 8, size=(K, N)).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    return x.bfloat16(), tq.pack_w4(w), scale


def _ulp_close(got, want, x2, packed, scale):
    """Every element of got within one bf16 ulp of want plus the f32
    reordering bound of its dot (module note)."""
    got, want = got.float(), want.float()
    lo, hi = t4.unpack_nibbles(packed)
    sabs = (x2[0].float().abs() @ lo.abs().float()
            + x2[1].float().abs() @ hi.abs().float()) * scale.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    K = 2 * x2.shape[2]
    diff = (got - want).abs()
    bad = diff > ulp + 2 * K * 2.0 ** -24 * sabs
    assert not bad.any(), (f"{int(bad.sum())} elements beyond 1 bf16 ulp; "
                           f"worst {diff.max().item()}")


@pytest.mark.parametrize("T,K,N,block_n", [
    (4, 64, 256, 128),       # tests/test_pallas_w4.py's shape
    (33, 512, 1024, 512),    # wider, ragged T
])
def test_plain_matches_jax_interpret_kernel(T, K, N, block_n):
    jnp = pytest.importorskip("jax.numpy")
    from lavida_mod_tpu.ops.pallas_w4 import split_even_odd, w4_matmul

    x, packed, scale = _inputs(T + K, T, K, N)
    want = w4_matmul(split_even_odd(jnp.asarray(x.float().numpy(),
                                                jnp.bfloat16)),
                     jnp.asarray(packed), jnp.asarray(scale),
                     block_n=block_n, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    x2 = t4.split_even_odd(x)
    pk, sc = torch.from_numpy(packed), torch.from_numpy(scale)
    got = t4.w4_matmul(x2, pk, sc)
    assert got.shape == (T, N) and got.dtype == torch.bfloat16
    _ulp_close(got, want, x2, pk, sc)


def test_pack_and_split_match_jax():
    jnp = pytest.importorskip("jax.numpy")
    from lavida_mod_tpu.ops import pallas_w4 as jw4

    rng = np.random.default_rng(5)
    w = rng.integers(-8, 8, size=(48, 24)).astype(np.int32)
    np.testing.assert_array_equal(tq.pack_w4(w), jw4.pack_w4(w))
    x = rng.standard_normal((7, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        t4.split_even_odd(torch.from_numpy(x)).numpy(),
        np.asarray(jw4.split_even_odd(jnp.asarray(x))))


def test_unpack_nibbles_inverts_pack_w4():
    rng = np.random.default_rng(6)
    w = rng.integers(-8, 8, size=(32, 40)).astype(np.int32)
    lo, hi = t4.unpack_nibbles(torch.from_numpy(tq.pack_w4(w)))
    np.testing.assert_array_equal(lo.numpy(), w[0::2])
    np.testing.assert_array_equal(hi.numpy(), w[1::2])


def test_cpu_route_counts_no_launch():
    x, packed, scale = _inputs(7, 5, 64, 48)
    x2 = t4.split_even_odd(x)
    before = t4.w4_matmul.launches
    got = t4.w4_matmul(x2, torch.from_numpy(packed), torch.from_numpy(scale))
    assert torch.equal(got, t4.w4_matmul_reference(
        x2, torch.from_numpy(packed), torch.from_numpy(scale)))
    assert t4.w4_matmul.launches == before


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("T,K,N", [
    (32, 4096, 12288),       # the TPU status note's decode shape
    (1056, 4096, 12288),     # the prefill's rows
    (5, 4304, 1000),         # no dimension a multiple of a tile
    (1, 16, 8),
])
def test_kernel_matches_plain_on_cuda(cuda, T, K, N):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    codes = torch.randint(-8, 8, (K, N), generator=g, device=cuda)
    packed = torch.from_numpy(tq.pack_w4(codes.cpu().numpy())).to(cuda)
    scale = torch.rand(N, generator=g, device=cuda) + 0.5
    x2 = t4.split_even_odd(x)
    before = t4.w4_matmul.launches
    out = t4.w4_matmul(x2, packed, scale)
    torch.cuda.synchronize()
    assert t4.w4_matmul.launches == before + 1
    _ulp_close(out, t4.w4_matmul_reference(x2, packed, scale), x2, packed,
               scale)


def test_kernel_rejects_bad_shapes_on_cuda(cuda):
    x2 = torch.zeros(2, 4, 32, dtype=torch.bfloat16, device=cuda)
    packed = torch.zeros(32, 16, dtype=torch.int8, device=cuda)
    scale = torch.ones(16, device=cuda)
    with pytest.raises(ValueError):
        t4.w4_matmul(x2.float(), packed, scale)
    with pytest.raises(ValueError):
        t4.w4_matmul(x2[:, :, :16].contiguous(), packed, scale)
    with pytest.raises(ValueError):
        t4.w4_matmul(x2, packed, scale[:8].contiguous())
