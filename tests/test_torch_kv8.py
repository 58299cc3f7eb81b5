"""The port's int8 KV cache ops (lavida_mod_tpu_torch.ops.kv8_attention,
kernel #8) against the JAX package's lavida_mod_tpu/ops/kv8_attention.py,
its Pallas kernel run in interpret mode on the CPU as tests/test_kv8.py
runs it.

  - `quantize_kv`, `dequantize_kv` and `write_rows` are bit-exact.
  - The kernel's plain version agrees with the interpret kernel at
    tests/test_kv8.py's tolerance (6e-3), with and without a front-padded
    `kv_valid`, with a batch row whose keys are all masked, for MHA (G = 1)
    and GQA (G = 4, 7), and past the 6400 keys the first CUDA kernel took:
    the two follow the same order (scores scaled by k_scale * sm_scale,
    masked to -1e30, the row softmaxed whole, p * v_scale rounded to bf16,
    the PV product) but their dot products sum in different orders.
  - `kv8_plan`'s constants are the ones csrc/kv8_attention.cu checks a plan
    against, and its layouts at the path shapes are pinned.
The CUDA kernel is held to the plain version by the tests that need a card
(skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_kv8.py
"""

import re
from pathlib import Path

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
    with pytest.raises(ValueError):
        tk.quantize_kv(x, bits=2)


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
    (2, 8, 4, 4, 64, 90, -1),          # row 0's keys all masked
    (1, 4, 2, 1, 64, 6500, 300),       # past the first kernel's S cap
    (1, 8, 14, 2, 64, 200, 23),        # Dream's GQA, G = 7
])
def test_plain_matches_interpret_kernel(B, T, H, Hkv, hd, S, pad):
    q, k8, ks, v8, vs = _attn_inputs(hash((B, T, H, S, pad)) % 1000, B, T,
                                     H, Hkv, hd, S)
    valid = None
    if pad:
        valid = torch.ones(B, S, dtype=torch.bool)
        valid[0, :pad if pad > 0 else S] = False      # row 0 front-padded
    got = tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)
    want = KV8.kv8_decode_attention(
        _jnp(q), *(jnp.asarray(t.numpy()) for t in (k8, ks, v8, vs)),
        kv_valid=None if valid is None else jnp.asarray(valid.numpy()))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL, rtol=TOL)


def test_all_masked_row_averages_over_every_key():
    """A batch row that sees no valid key scores -1e30 everywhere, so its
    softmax is uniform over all S keys, as the TPU kernel's is."""
    q, k8, ks, v8, vs = _attn_inputs(7, 1, 4, 2, 2, 64, 50)
    out = tk.kv8_decode_attention(q, k8, ks, v8, vs,
                                  torch.zeros(1, 50, dtype=torch.bool))
    mean = tk.dequantize_kv(v8, vs).mean(1)            # [1, Hkv, hd]
    np.testing.assert_allclose(out.float().numpy(),
                               mean[:, None].expand(1, 4, 2, 64).numpy(),
                               atol=TOL, rtol=TOL)


def _cuda_source():
    return (Path(tk.__file__).parents[1] / "csrc"
            / "kv8_attention.cu").read_text()


def test_plan_constants_match_the_cuda_source():
    """The plan's constants are the ones csrc/kv8_attention.cu checks a
    plan against, and its shared-memory formula is the source's."""
    src = _cuda_source()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m[1])

    assert const("kKeys") == tk.KV8_KEYS
    assert const("kMaxStages") == tk.KV8_MAX_STAGES
    assert const("kMaxWarps") == tk.KV8_MAX_WARPS
    assert const("kScaleBytes") == tk.KV8_SCALE_BYTES
    assert const("kMaxG") == tk.KV8_MAX_G
    assert const("kSmemLimit") == tk.SMEM_LIMIT
    assert "return 2 * kKeys * (hd * bits / 8) + kScaleBytes;" in src
    assert "const int ring = stages * stage_bytes(hd, bits);" in src
    assert "const int merge = (splits - 1) * row_tiles * (64 * hd + 512);" \
        in src
    for hd in (16, 32, 64, 128, 256):   # an instance per head dim
        assert f"case {hd}:" in src or hd == 256


# (B, T, H, Hkv, S, hd) -> (row_tiles, row_blocks, splits, chunks, stages,
# units) on 132 SMs: the B = 4 and B = 8 kv8 batches (LLaDA-8B), Dream-7B's
# GQA (28 / 4 heads) at B = 4 and 1, a long cache, hd 64 and 256, the
# smallest shapes
PLANS = [((4, 32, 32, 32, 1184, 128), (2, 1, 4, 1, 2, 128)),
         ((8, 32, 32, 32, 1184, 128), (2, 1, 4, 1, 2, 256)),
         ((4, 32, 28, 4, 1184, 128), (7, 2, 1, 4, 2, 128)),
         ((1, 32, 28, 4, 1184, 128), (7, 2, 1, 10, 2, 80)),
         ((1, 32, 32, 32, 16384, 128), (2, 1, 4, 4, 2, 128)),
         ((2, 32, 4, 4, 6401, 64), (2, 1, 4, 13, 2, 104)),
         ((2, 32, 4, 4, 1184, 256), (2, 1, 2, 10, 2, 80)),
         ((1, 13, 8, 2, 77, 64), (4, 1, 2, 1, 2, 2)),
         ((1, 1, 1, 1, 1, 16), (1, 1, 4, 1, 2, 1))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan_at_path_shapes(shape, want):
    p = tk.kv8_plan(*shape, 132)
    assert (p.row_tiles, p.row_blocks, p.splits, p.chunks, p.stages,
            p.units) == want
    B, T, H, Hkv, S, hd = shape
    max_warps = 8 if hd <= 128 else 4
    assert p.row_tiles * p.splits <= max_warps
    assert (p.row_blocks - 1) * p.row_tiles * 16 < H // Hkv * T \
        <= p.row_blocks * p.row_tiles * 16
    tiles = -(-S // tk.KV8_KEYS)
    per = -(-tiles // p.chunks)
    assert (p.chunks - 1) * per < tiles             # no chunk is empty
    assert p.smem <= tk.SMEM_LIMIT


def test_plan_refuses_what_the_kernel_does_not_take():
    for shape in [(1, 32, 34, 2, 100, 128),     # G = 17
                  (1, 32, 8, 3, 100, 128),      # H % Hkv
                  (1, 32, 8, 8, 100, 48),       # hd 48 does not divide 256
                  (1, 32, 8, 8, 0, 128)]:
        with pytest.raises(ValueError):
            tk.kv8_plan(*shape, 132)


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


def _cuda_inputs(g, device, B, T, H, Hkv, hd, S):
    q = torch.randn(B, T, H, hd, generator=g, device=device).bfloat16()
    k8, ks = tk.quantize_kv(torch.randn(B, S, Hkv, hd, generator=g,
                                        device=device).bfloat16())
    v8, vs = tk.quantize_kv(torch.randn(B, S, Hkv, hd, generator=g,
                                        device=device).bfloat16())
    return q, k8, ks, v8, vs


# (B, T, H, Hkv, hd, S, pad): row 0 front-padded by `pad` keys (-1: every
# key of row 0 masked), row b > 0 by (37 b) % (S // 4)
CUDA_CASES = [
    (4, 32, 32, 32, 128, 1184, 32),    # the B = 4 kv8 batch (one chunk)
    (8, 32, 32, 32, 128, 1184, 0),     # the B = 8 batch: two waves
    (1, 13, 8, 2, 64, 77, 5),          # ragged T and S, G = 4, hd 64
    (2, 32, 16, 1, 128, 300, 0),       # G = 16: four row blocks, chunks
    (2, 32, 4, 4, 64, 6401, 0),        # past the first kernel's cap
    (1, 32, 8, 8, 128, 16384, 700),    # a long cache, many chunks
    (4, 32, 28, 4, 128, 1184, 0),      # Dream-7B's GQA, G = 7
    (1, 32, 28, 4, 128, 1184, 400),    # a front pad longer than a chunk
    (2, 32, 32, 32, 128, 1184, -1),    # a batch row with every key masked
    (2, 32, 28, 4, 128, 1184, -1),     # the same in chunks
    (2, 32, 8, 8, 256, 500, 9),        # hd 256
    (2, 16, 8, 4, 32, 200, 3),         # hd 32
    (1, 8, 4, 2, 16, 130, 0),          # hd 16
]


def _valid(B, S, pad, device):
    valid = torch.ones(B, S, dtype=torch.bool, device=device)
    for b in range(B):
        valid[b, :(pad if pad >= 0 else S) if b == 0
              else (37 * b) % max(1, S // 4)] = False
    return valid


@pytest.mark.parametrize("B,T,H,Hkv,hd,S,pad", CUDA_CASES)
def test_kernel_matches_plain_on_cuda(cuda, B, T, H, Hkv, hd, S, pad):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k8, ks, v8, vs = _cuda_inputs(g, cuda, B, T, H, Hkv, hd, S)
    valid = _valid(B, S, pad, cuda)
    before = tk.kv8_decode_attention.launches
    out = tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)
    torch.cuda.synchronize()
    assert tk.kv8_decode_attention.launches == before + 1
    ref = tk.kv8_decode_attention_reference(q, k8, ks, v8, vs, valid)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    # no mask is every key valid; the same bits on a second run
    if pad == 0:
        torch.testing.assert_close(
            tk.kv8_decode_attention(q, k8, ks, v8, vs).float(),
            tk.kv8_decode_attention_reference(q, k8, ks, v8, vs).float(),
            atol=TOL, rtol=TOL)
    assert torch.equal(tk.kv8_decode_attention(q, k8, ks, v8, vs, valid), out)


def test_chained_calls_over_a_cache_written_in_place_on_cuda(cuda):
    """20 calls without a sync, each after write_rows has put new rows into
    the same buffers (the kernel's tensor maps are cached by address), each
    held to the plain version on the cache as it was."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, T, H, Hkv, hd, S = 4, 32, 32, 32, 128, 1184
    q, k8, ks, v8, vs = _cuda_inputs(g, cuda, B, T, H, Hkv, hd, S)
    valid = _valid(B, S, 32, cuda)
    outs, refs = [], []
    for i in range(20):
        q = torch.randn(B, T, H, hd, generator=g, device=cuda).bfloat16()
        new = [torch.randn(B, T, Hkv, hd, generator=g,
                           device=cuda).bfloat16() for _ in range(2)]
        tk.write_rows(k8, ks, v8, vs, *new, (53 * i) % (S - T))
        outs.append(tk.kv8_decode_attention(q, k8, ks, v8, vs, valid))
        refs.append(tk.kv8_decode_attention_reference(q, k8, ks, v8, vs,
                                                      valid))
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL,
                                   rtol=TOL)


def test_wrapper_takes_long_caches_and_checks_its_inputs_on_cuda(cuda):
    """Past S = 6400 (the first CUDA kernel's cap) the wrapper launches;
    what the kernel does not take still raises."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k8, ks, v8, vs = _cuda_inputs(g, cuda, 1, 8, 2, 2, 64, 6401)
    before = tk.kv8_decode_attention.launches
    tk.kv8_decode_attention(q, k8, ks, v8, vs)
    assert tk.kv8_decode_attention.launches == before + 1
    with pytest.raises(ValueError, match="kv_valid"):
        tk.kv8_decode_attention(q, k8, ks, v8, vs,
                                torch.ones(1, 6401, dtype=torch.int32,
                                           device=cuda))
    with pytest.raises(ValueError, match="k8"):
        tk.kv8_decode_attention(q, k8[..., :48].contiguous(), ks, v8, vs)
    with pytest.raises(ValueError):
        tk.kv8_decode_attention(q.float(), k8, ks, v8, vs)
