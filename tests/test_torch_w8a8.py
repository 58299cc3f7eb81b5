"""The port's W8A8 matmul (lavida_mod_tpu_torch.ops.w8a8) against the JAX
package's Pallas kernel run in interpret mode on the CPU (as
tests/test_pallas_w8.py runs it) and against `linear_act_int8`'s XLA math.

The integer product is exact in both and the epilogue rounds in the same
order, so the plain version is bit-exact with the kernel (no excess
precision is involved: the only bf16 rounding is the last one).  The CUDA
kernel is held to the plain version on the card, bit-exact too, at the
prefill's four (K, N) pairs:
    python -m pytest --noconftest -k cuda tests/test_torch_w8a8.py
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.ops import quant as tq
from lavida_mod_tpu_torch.ops import w8a8 as t8

torch.set_num_threads(2)


def _mk(seed, T, K, N):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    return x.bfloat16(), w


@pytest.mark.parametrize("T,K,N,block_t,block_n", [
    (8, 256, 256, 8, 128),
    (300, 128, 128, 256, 128),       # ragged T
    (300, 8192, 128, 256, 128),      # k-blocked accumulator
    (64, 4304, 4304, 64, 128),       # SigLIP fc widths: K, N pad to 128
])
def test_plain_bit_exact_with_jax_kernel(T, K, N, block_t, block_n):
    jnp = pytest.importorskip("jax.numpy")
    from lavida_mod_tpu.ops.pallas_w8 import quantize_act_int8, w8a8_matmul
    from lavida_mod_tpu.ops.quant import quantize_linear

    x, w = _mk(T + K, T, K, N)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    p = quantize_linear({"kernel": jnp.asarray(w)})
    x8, sx = quantize_act_int8(xj)
    want = w8a8_matmul(x8, sx, p["kernel_q"], p["scale"], block_t=block_t,
                       block_n=block_n, interpret=True)
    x8t, sxt = tq.quantize_act_int8(x)
    np.testing.assert_array_equal(x8t.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(sxt.numpy(), np.asarray(sx))
    q, s = tq.quantize_linear(torch.from_numpy(np.ascontiguousarray(w.T)))
    got = t8.w8a8_matmul(x8t, sxt, q, s)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("lead", [(16,), (2, 8)])
def test_linear_w8a8_matches_linear_act_int8(lead):
    """The whole linear (A8 codes + matmul + cast) equals the JAX
    `linear_act_int8` on a bf16 input, with leading batch dims."""
    jnp = pytest.importorskip("jax.numpy")
    from lavida_mod_tpu.ops.quant import linear_act_int8, quantize_linear

    x, w = _mk(5, int(np.prod(lead)), 128, 256)
    xb = x.reshape(*lead, 128)
    p = quantize_linear({"kernel": jnp.asarray(w)})
    want = linear_act_int8(jnp.asarray(xb.float().numpy(), jnp.bfloat16), p)
    q, s = tq.quantize_linear(torch.from_numpy(np.ascontiguousarray(w.T)))
    got = t8.linear_w8a8(xb, q, s)
    assert got.shape == (*lead, 256) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_int8_linear_module_routes():
    x, w = _mk(6, 4, 128, 64)
    lin = torch.nn.Linear(128, 64, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
    m = tq.Int8Linear.from_linear(lin)
    before = t8.w8a8_matmul.launches
    a8 = m(x, act_int8=True)
    assert torch.equal(a8, t8.linear_w8a8(x, m.weight_q, m.scale))
    wo = m(x.float())                     # weight-only: codes * scale
    assert torch.allclose(wo, x.float() @ (m.weight_q.float().t()
                                           * m.scale), rtol=1e-5, atol=1e-4)
    assert t8.w8a8_matmul.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("T,K,N", [(1056, 4096, 12288), (1056, 4096, 4096),
                                   (1056, 4096, 24576), (1056, 12288, 4096),
                                   (77, 208, 200), (5, 4304, 1152),
                                   # the wgmma tiles' edges: one row, one
                                   # 16-byte K slice, ragged K and N, odd N
                                   (1, 4096, 4096), (7, 16, 24),
                                   (77, 4304, 1000), (33, 4304, 1001),
                                   (1, 16, 1), (300, 12288, 136)])
def test_kernel_matches_plain_on_cuda(cuda, T, K, N):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    w = torch.randn(N, K, generator=g, device=cuda) * 0.02
    q, s = tq.quantize_linear(w)
    x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W8)
    x8p, sxp = tq.quantize_act_int8(x)
    assert torch.equal(x8, x8p) and torch.equal(sx, sxp)
    before = t8.w8a8_matmul.launches
    out = t8.w8a8_matmul(x8, sx, q, s)
    torch.cuda.synchronize()
    assert t8.w8a8_matmul.launches == before + 1
    assert torch.equal(out, t8.w8a8_matmul_reference(x8, sx, q, s))


def test_w4_act_quant_kernel_matches_plain_on_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(33, 4096, generator=g, device=cuda).bfloat16()
    x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W4)
    x8p, sxp = tq.quantize_act_w4(x)
    assert torch.equal(x8, x8p) and torch.equal(sx, sxp)
