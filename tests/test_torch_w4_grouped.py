"""The port's grouped int4 W4A8 matmul (lavida_mod_tpu_torch.ops.w4_grouped,
kernel #4) against the JAX package's Pallas `w4_matmul_grouped` run in
interpret mode on the CPU.

  - The plain version follows the TPU kernel's f32 order (a partial sum per
    k-block of groups, added to the accumulator; the epilogue acc * sx),
    with the activation scale `max(amax, 1e-8) * f32(1/127)` that XLA
    compiles the wrapper's `/ 127.0` into.  With XLA's excess precision off
    (tests/torch_jax_strict.py) the two are bit-exact at the LLaDA widths
    (K = 4096 and 12288: one and three k-blocks of 32 groups), ragged T
    and a trimmed N included.  At a k-block of 2 or 4 groups XLA's CPU
    compile of the interpret kernel sums the unrolled groups in another
    order (the add chain of its HLO; a permutation of the groups
    reproduces its output exactly), so there a few elements in 10^4 land
    one bf16 rounding apart, and the test bounds that.
  - The JAX model off the TPU runs `_linear_w4`'s einsum fallback, which
    the port's CPU model path keeps (`quant.linear_w4_reference`); the two
    plain forms agree within tests/test_pallas_w4.py's 2 % band.
The CUDA kernel is held to the plain version, bit for bit, by the tests
that need a card (skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_w4_grouped.py
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.ops import quant as tq
from lavida_mod_tpu_torch.ops import w4_grouped as tg
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

# (T, K, N, true N): K = 768 and 12288 are three k-blocks (of 2 and of 32
# groups); N = 600 is padded to 1024 and trimmed
CASES = [(32, 512, 512, 512), (37, 768, 512, 512), (8, 12288, 512, 512),
         (5, 4096, 1024, 600), (128, 1024, 1536, 1536)]


def _inputs(i, T, K, N, n):
    rng = np.random.default_rng(i)
    w = rng.standard_normal((K, n)).astype(np.float32) * 0.05
    packed, scales, _ = tq.quantize_linear4_np(w)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)) \
        .bfloat16().float().numpy()
    return dict(x=x, packed=packed, scales=scales)


def _port(a, n):
    x = torch.from_numpy(a["x"]).bfloat16()
    y = tg.w4_matmul_grouped(x, tq.w4_from_jax_packed(a["packed"]),
                             torch.from_numpy(a["scales"]))
    return y[:, :n].float().numpy()


def test_groups_per_kblock():
    """pallas_w4.py:194-195's k-block, in groups."""
    assert tg.groups_per_kblock(4096) == 32
    assert tg.groups_per_kblock(12288) == 32
    assert tg.groups_per_kblock(768) == 2
    assert tg.groups_per_kblock(384) == 1
    assert tg.groups_per_kblock(20480) == 32


def test_plain_matches_interpret_kernel(tmp_path):
    inputs = {}
    for i, case in enumerate(CASES):
        inputs.update({f"{i}/{k}": v for k, v in _inputs(i, *case).items()})
    ref = strict_jax(f"""
import jax.numpy as jnp
from lavida_mod_tpu.ops.pallas_w4 import w4_matmul_grouped
for i, n in enumerate({[c[3] for c in CASES]!r}):
    y = w4_matmul_grouped(jnp.asarray(IN[f"{{i}}/x"], jnp.bfloat16),
                          jnp.asarray(IN[f"{{i}}/packed"]),
                          jnp.asarray(IN[f"{{i}}/scales"]), interpret=True)
    OUT[str(i)] = np.asarray(y[:, :n].astype(jnp.float32))
""", tmp_path, inputs)
    for i, case in enumerate(CASES):
        got = _port(_inputs(i, *case), case[3])
        want = ref[str(i)]
        if case[1] >= 4096:          # the LLaDA widths: 32-group k-blocks
            np.testing.assert_array_equal(got, want, err_msg=str(case))
            continue
        # a few-group k-block: XLA sums the unrolled groups in another
        # order (module note): a few elements in 10^4 differ, by at most a
        # bf16 rounding of the largest output
        off = got != want
        assert off.mean() < 1e-3, (case, off.sum())
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_within_band_of_linear_w4_reference(i):
    """The kernel-order plain version against the einsum form the JAX
    model runs off the TPU (and the port's CPU model path)."""
    T, K, N, n = CASES[i]
    a = _inputs(i, *CASES[i])
    got = _port(a, n)
    want = tq.linear_w4_reference(
        torch.from_numpy(a["x"]).bfloat16(),
        tq.w4_from_jax_packed(a["packed"]), torch.from_numpy(a["scales"]),
        n).float().numpy()
    assert got.shape == want.shape == (T, n)
    assert np.abs(got - want).max() / np.abs(want).max() < 0.02


def test_cpu_route_counts_no_launch():
    before = tg.w4_matmul_grouped.launches
    _port(_inputs(0, *CASES[0]), CASES[0][3])
    assert tg.w4_matmul_grouped.launches == before


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("T,K,N", [(128, 4096, 4096), (128, 12288, 4096),
                                   (256, 4096, 126464), (4608, 4096, 12288),
                                   (77, 768, 576)])
def test_kernel_bit_equal_to_plain_on_cuda(cuda, T, K, N):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    w = torch.randn(N, K, generator=g, device=cuda) * 0.02
    packed, scales, _ = tq.quantize_linear4(w)
    before = tg.w4_matmul_grouped.launches
    out = tg.w4_matmul_grouped(x, packed, scales)
    torch.cuda.synchronize()
    assert tg.w4_matmul_grouped.launches == before + 1
    assert torch.equal(out, tg.w4_matmul_grouped_reference(x, packed, scales))


def test_kernel_rejects_bad_shapes_on_cuda(cuda):
    x = torch.zeros(4, 256, dtype=torch.bfloat16, device=cuda)
    packed = torch.zeros(8, 2, 512, dtype=torch.uint8, device=cuda)
    scales = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError):
        tg.w4_matmul_grouped(x.float(), packed, scales)
    with pytest.raises(ValueError):
        tg.w4_matmul_grouped(x[:, :128], packed, scales)
    with pytest.raises(ValueError):
        tg.w4_matmul_grouped(x, packed[:4], scales)
