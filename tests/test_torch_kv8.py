"""The port's int8 KV cache ops (lavida_mod_tpu_torch.ops.kv8_attention,
kernel #8) against the JAX package's lavida_mod_tpu/ops/kv8_attention.py,
its Pallas kernel run in interpret mode on the CPU as tests/test_kv8.py
runs it.

  - `quantize_kv`, `dequantize_kv` and `write_rows` are bit-exact.
  - The kernel's plain version agrees with the interpret kernel at
    tests/test_kv8.py's tolerance (6e-3), with and without a front-padded
    `kv_valid`, for MHA (G = 1) and GQA (G = 4): the two follow the same
    order (scores scaled by k_scale * sm_scale, masked to -1e30, the row
    softmaxed whole, p * v_scale rounded to bf16, the PV product) but
    their dot products sum in different orders.
The CUDA kernel is held to the plain version by the tests that need a card
(skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_kv8.py
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lavida_mod_tpu.ops import kv8_attention as KV8
from lavida_mod_tpu_torch.ops import kv8_attention as tk

TOL = 6e-3


@pytest.fixture(autouse=True)
def _interpret():
    KV8._INTERPRET[0] = True
    yield
    KV8._INTERPRET[0] = False


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jnp(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def test_quantize_and_dequantize_bit_exact():
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((2, 40, 4, 128)) * 3.0)
    x[0, 3] = 0.0                                  # an all-zero row: 1e-8
    q, s = tk.quantize_kv(x)
    jq, js = KV8.quantize_kv(_jnp(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.shape == (2, 4, 40, 128) and s.shape == (2, 4, 1, 40)
    np.testing.assert_array_equal(tk.dequantize_kv(q, s).numpy(),
                                  np.asarray(KV8.dequantize_kv(jq, js)))
    with pytest.raises(NotImplementedError):
        tk.quantize_kv(x, bits=4)


def test_write_rows_bit_exact_and_in_place():
    rng = np.random.default_rng(1)
    B, H, S, hd, T = 2, 3, 48, 64, 8
    k8 = torch.from_numpy(rng.integers(-127, 128, (B, H, S, hd), np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (B, H, S, hd), np.int8))
    ks = torch.from_numpy(rng.random((B, H, 1, S), np.float32))
    vs = torch.from_numpy(rng.random((B, H, 1, S), np.float32))
    k_new = _bf16(rng.standard_normal((B, T, H, hd)))
    v_new = _bf16(rng.standard_normal((B, T, H, hd)))
    want = KV8.write_rows(*(jnp.asarray(t.numpy()) for t in (k8, ks, v8, vs)),
                          _jnp(k_new), _jnp(v_new), 16)
    bufs = (k8, ks, v8, vs)
    got = tk.write_rows(*bufs, k_new, v_new, 16)
    for g, w, b in zip(got, want, bufs):
        assert g is b                                # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _attn_inputs(seed, B, T, H, Hkv, hd, S):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((B, T, H, hd)))
    k8, ks = tk.quantize_kv(_bf16(rng.standard_normal((B, S, Hkv, hd))))
    v8, vs = tk.quantize_kv(_bf16(rng.standard_normal((B, S, Hkv, hd))))
    return q, k8, ks, v8, vs


@pytest.mark.parametrize("B,T,H,Hkv,hd,S,pad", [
    (2, 32, 4, 4, 128, 160, 0),        # MHA (G = 1)
    (2, 32, 4, 4, 128, 160, 37),       # front-padded prefix
    (1, 16, 8, 2, 128, 96, 0),         # GQA, G = 4
    (2, 8, 8, 2, 64, 72, 11),          # GQA, padded, hd 64
])
def test_plain_matches_interpret_kernel(B, T, H, Hkv, hd, S, pad):
    q, k8, ks, v8, vs = _attn_inputs(hash((B, T, H, S, pad)) % 1000, B, T,
                                     H, Hkv, hd, S)
    valid = None
    if pad:
        valid = torch.ones(B, S, dtype=torch.bool)
        valid[0, :pad] = False                        # row 0 front-padded
    got = tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)
    want = KV8.kv8_decode_attention(
        _jnp(q), *(jnp.asarray(t.numpy()) for t in (k8, ks, v8, vs)),
        kv_valid=None if valid is None else jnp.asarray(valid.numpy()))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL, rtol=TOL)


def test_cpu_route_counts_no_launch():
    before = tk.kv8_decode_attention.launches
    tk.kv8_decode_attention(*_attn_inputs(0, 1, 8, 2, 2, 64, 40))
    assert tk.kv8_decode_attention.launches == before


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,T,H,Hkv,hd,S,pad", [
    (4, 32, 32, 32, 128, 1184, 32), (8, 32, 32, 32, 128, 1184, 0),
    (1, 13, 8, 2, 64, 77, 5), (2, 32, 16, 1, 128, 300, 0)])
def test_kernel_matches_plain_on_cuda(cuda, B, T, H, Hkv, hd, S, pad):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, T, H, hd, generator=g, device=cuda).bfloat16()
    k8, ks = tk.quantize_kv(torch.randn(B, S, Hkv, hd, generator=g,
                                        device=cuda).bfloat16())
    v8, vs = tk.quantize_kv(torch.randn(B, S, Hkv, hd, generator=g,
                                        device=cuda).bfloat16())
    valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    valid[0, :pad] = False
    before = tk.kv8_decode_attention.launches
    out = tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)
    torch.cuda.synchronize()
    assert tk.kv8_decode_attention.launches == before + 1
    ref = tk.kv8_decode_attention_reference(q, k8, ks, v8, vs, valid)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
