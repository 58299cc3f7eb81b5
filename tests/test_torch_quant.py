"""The port's quantizers and quantized-linear math (lavida_mod_tpu_torch.ops.
quant) against the JAX package's host quantizers and `ops/quant.py`.

Every twin is bit-exact: the numpy copies against the JAX/numpy originals,
the torch quantizers (which run on the card in the mixed layout) against
the numpy copies, and the fragment layout of the int4 codes against the
JAX `pack_w4` nibble order in both directions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lavida_mod_tpu.ops import pallas_w4 as jw4
from lavida_mod_tpu.ops import pallas_w8 as jw8
from lavida_mod_tpu.ops import quant as jq
from lavida_mod_tpu_torch.ops import quant as tq

torch.set_num_threads(2)


def _w(seed, K, N, scale=0.05):
    return (np.random.default_rng(seed).standard_normal((K, N))
            .astype(np.float32) * scale)


@pytest.mark.parametrize("K", [128, 4096, 8192, 8320, 12288, 18944])
def test_padded_in_dim(K):
    assert tq.padded_in_dim(K) == jw4.padded_in_dim(K)


@pytest.mark.parametrize("K,N", [(256, 384), (128, 8)])
def test_pack_and_group_quantizer_twins(K, N):
    w = _w(0, K, N)
    codes = np.random.default_rng(1).integers(-8, 8, (K, N))
    np.testing.assert_array_equal(tq.pack_w4(codes), jw4.pack_w4(codes))
    packed, scales = tq.quantize_w4_grouped(w)
    jp, js = jw4.quantize_w4_grouped(w)
    np.testing.assert_array_equal(packed, jp)
    np.testing.assert_array_equal(scales, js)


@pytest.mark.parametrize("K,N", [(256, 384), (8320, 64), (130, 40)])
def test_quantize_linear_twins(K, N):
    """int8: numpy twin == JAX quantize_linear; torch twin (nn.Linear
    layout [N, K]) == numpy twin transposed."""
    w = _w(2, K, N)
    jp = jq.quantize_linear({"kernel": jnp.asarray(w)})
    q, s = tq.quantize_linear_np(w)
    np.testing.assert_array_equal(q, np.asarray(jp["kernel_q"]))
    np.testing.assert_array_equal(s, np.asarray(jp["scale"]))
    qt, st = tq.quantize_linear(torch.from_numpy(np.ascontiguousarray(w.T)))
    np.testing.assert_array_equal(qt.numpy(), q.T)
    np.testing.assert_array_equal(st.numpy(), s)


@pytest.mark.parametrize("K,N", [(256, 384), (8320, 64), (512, 1024)])
def test_quantize_linear4_twins(K, N):
    """int4 with the K pad (padded_in_dim) and the 512-column N pad: numpy
    twin == JAX quantize_linear4 (trim key included); torch twin == numpy
    twin in the fragment layout."""
    w = _w(3, K, N)
    jp = jq.quantize_linear4({"kernel": jnp.asarray(w)})
    packed, scales, n = tq.quantize_linear4_np(w)
    np.testing.assert_array_equal(packed, np.asarray(jp["kernel_p4"]))
    np.testing.assert_array_equal(scales, np.asarray(jp["scales4"]))
    trim = [k for k in jp if k.startswith("__trim_")]
    assert n == N and trim == ([] if N % 512 == 0 else [f"__trim_{N}__"])
    pt, st, nt = tq.quantize_linear4(
        torch.from_numpy(np.ascontiguousarray(w.T)))
    assert nt == N
    assert torch.equal(pt, tq.w4_from_jax_packed(packed))
    np.testing.assert_array_equal(st.numpy(), scales)


def test_fragment_layout_nibble_order():
    """Byte j of word s of lane L of (tile nt, group g) holds row
    k = 128 g + 32 s + 4 (L % 4) + j of column 8 nt + L // 4 in its low
    nibble and row k + 16 in its high nibble; the JAX bytes hold row 2k
    low and 2k+1 high."""
    rng = np.random.default_rng(4)
    K, N = 256, 16
    codes = rng.integers(-8, 8, (K, N)).astype(np.int8)
    frag = tq.pack_w4_frag(torch.from_numpy(codes)).numpy()
    assert frag.shape == (N // 8, K // 128, 512)
    for nt, g, L, s, j in [(0, 0, 0, 0, 0), (1, 1, 31, 3, 3),
                           (0, 1, 6, 2, 1), (1, 0, 13, 1, 2)]:
        byte = int(frag[nt, g, L * 16 + s * 4 + j])
        k, n = 128 * g + 32 * s + 4 * (L % 4) + j, 8 * nt + L // 4
        assert byte & 0xF == codes[k, n] & 0xF
        assert byte >> 4 == codes[k + 16, n] & 0xF
    jpacked = jw4.pack_w4(codes)
    assert int(jpacked[0, 0]) & 0xF == codes[0, 0] & 0xF
    np.testing.assert_array_equal(tq.unpack_w4_jax(jpacked), codes)
    np.testing.assert_array_equal(tq.unpack_w4(torch.from_numpy(frag))
                                  .numpy(), codes)
    assert torch.equal(tq.w4_from_jax_packed(jpacked),
                       torch.from_numpy(frag))


def test_activation_scale_formulas_differ_and_match_jax():
    """The two per-token scales of the repo: W8A8 `max(amax / 127, 1e-8)`
    (pallas_w8.py:45) and W4A8 `max(amax, 1e-8) / 127` (w4_fused.py:72-73,
    quant.py:151-153).  A row of tiny values tells them apart; each port
    function follows its own JAX original bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    x[1] *= 1e-7                      # amax / 127 below the 1e-8 floor
    x[2] = 0.0
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    q8, s8 = tq.quantize_act_int8(xb)
    jq8, js8 = jw8.quantize_act_int8(xj)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(s8.numpy(), np.asarray(js8))
    q4, s4 = tq.quantize_act_w4(xb)
    xf = np.asarray(xj.astype(jnp.float32))
    js4 = np.maximum(np.abs(xf).max(-1, keepdims=True),
                     np.float32(1e-8)) / np.float32(127.0)
    np.testing.assert_array_equal(s4.numpy(), js4)
    np.testing.assert_array_equal(
        q4.numpy(), np.clip(np.round(xf / js4), -127, 127).astype(np.int8))
    assert s8[1].item() == np.float32(1e-8) and s4[1].item() < 1e-8


@pytest.mark.parametrize("K,N", [(256, 384), (384, 512)])
def test_linear_w4_reference_matches_jax_cpu_math(K, N):
    """`_linear_w4`'s CPU branch, the oracle of tests/test_w4_fused.py,
    including the N trim, for bf16 and f32 inputs and an f32 `preferred`
    (the logits head)."""
    w = _w(6, K, N)
    jp = jq.quantize_linear4({"kernel": jnp.asarray(w)})
    packed, scales, n = tq.quantize_linear4_np(w)
    frag, sc = tq.w4_from_jax_packed(packed), torch.from_numpy(scales)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 5, K)).astype(np.float32)).bfloat16()
    for xt, preferred in [(x, None), (x.float(), None),
                          (x, torch.float32)]:
        xj = jnp.asarray(xt.float().numpy(),
                         jnp.bfloat16 if xt.dtype == torch.bfloat16
                         else jnp.float32)
        want = jq._linear_w4(xj, jp, None if preferred is None
                             else jnp.float32)
        got = tq.linear_w4_reference(xt, frag, sc, n, preferred)
        assert got.shape == (2, 5, N) and got.dtype == (preferred or
                                                          xt.dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-2)


def test_quantize_module_falls_back_to_int8_on_ragged_k():
    """quantize_params(bits=4) keeps int8 where K breaks the 128-group
    (llada.py:828), and int4 linears hold their true out width."""
    lin = torch.nn.Linear(130, 40, bias=False)
    assert isinstance(tq.quantize_module(lin, 4), tq.Int8Linear)
    lin = torch.nn.Linear(256, 40, bias=False)
    m = tq.quantize_module(lin, 4)
    assert isinstance(m, tq.Int4Linear) and m.out_features == 40
    assert m.padded and m.scales.shape == (2, 512)
    assert isinstance(tq.quantize_module(lin, 8), tq.Int8Linear)
    with pytest.raises(NotImplementedError):
        tq.quantize_module(torch.nn.Linear(256, 40, bias=True), 4)
