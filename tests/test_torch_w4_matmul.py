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

import re
from pathlib import Path

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
# the kernel's plan and arithmetic, on the CPU
# ---------------------------------------------------------------------------

def test_plan_constants_match_the_cuda_source():
    """The plan's constants are the ones csrc/w4_matmul.cu checks a plan
    against, and every row block the plan can choose has its wgmma
    instance and its case."""
    src = (Path(t4.__file__).parents[1] / "csrc" / "w4_matmul.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m[1])

    assert const("kBK") == t4.STAGE_ROWS
    assert const("kCols") == t4.COLS
    assert const("kDecMaxRows") == t4.DECODE_MAX_ROWS
    assert const("kMaxSplits") == t4.MAX_SPLITS
    assert const("kMaxStages") == t4.MAX_STAGES
    assert const("kSmemLimit") == t4.SMEM_LIMIT
    assert "return 2 * bt * 128 + kBK * kCols;" in src   # stage_bytes
    assert t4.stage_bytes(32) == 2 * 32 * 128 + t4.STAGE_ROWS * t4.COLS
    assert "constexpr int kThreads = kConsumers + kProducers;" in src
    assert const("kConsumers") == 256   # two warpgroups of 64 columns
    assert const("kProducers") == 128   # a warpgroup: setmaxnreg
    assert "int want = T <= 8 ? 8 : T <= 16 ? 16 : T <= 32 ? 32 : 64;" in src
    assert t4.DECODE_ROWS == (8, 16, 32, 64)
    for bt in t4.DECODE_ROWS + t4.PREFILL_ROWS:
        assert f"wgmma.mma_async.sync.aligned.m64n{bt}k16.f32.bf16.bf16" in src
        assert f"case {bt}:" in src or bt == t4.PREFILL_ROWS[-1]
    assert "bt == 128 || bt == 256" in src


def test_regime_boundary():
    """Up to 64 rows one decode row block holds them all; 65 rows take
    the prefill's blocks of 128 or 256."""
    assert [t4.plan(T, 2048, 12288, 132).bt for T in (1, 8, 9, 16, 17, 33, 64)] \
        == [8, 8, 16, 16, 32, 64, 64]
    assert [t4.plan(T, 2048, 12288, 132).regime for T in (1, 64, 65, 256)] \
        == ["decode", "decode", "prefill", "prefill"]
    assert t4.plan(65, 2048, 12288, 132).bt == 128
    for T in (65, 256, 300, 1056, 4608):
        assert t4.plan(T, 2048, 4096, 132).bt in t4.PREFILL_ROWS


# (T, K/2, N) -> (bt, row_blocks, splits, stages per split, ctas) on 132
# SMs: the decode shape (96 tiles of 128 columns, no split: a unit's fixed
# cost outweighs the 36 idle SMs), its T = 1, the regime's edges, the
# prefill (9 row blocks of 128), the ragged shape (8 tiles, 12 splits of 3
# stages, the last 1), the card test's smallest, a K/2 not a multiple of
# the stage, one column tile of three row blocks (16 splits), a ragged
# width with row blocks and splits, and a 4608-row prefill
PLANS = [((32, 2048, 12288), (32, 1, 1, 32, 96)),
         ((1, 2048, 12288), (8, 1, 1, 32, 96)),
         ((64, 2048, 12288), (64, 1, 1, 32, 96)),
         ((65, 2048, 12288), (128, 1, 1, 32, 96)),
         ((256, 2048, 12288), (256, 1, 1, 32, 96)),
         ((1056, 2048, 12288), (128, 9, 1, 32, 132)),
         ((5, 2152, 1000), (8, 1, 12, 3, 96)),
         ((1, 8, 8), (8, 1, 1, 1, 1)),
         ((70, 100, 24), (128, 1, 1, 2, 1)),
         ((300, 2048, 128), (128, 3, 16, 2, 48)),
         ((300, 2048, 1000), (128, 3, 5, 7, 120)),
         ((4608, 2048, 4096), (256, 18, 1, 32, 132))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan(shape, want):
    p = t4.plan(*shape, 132)
    assert (p.bt, p.row_blocks, p.splits, p.kps, p.ctas) == want
    T, K2, N = shape
    assert p.col_tiles == -(-N // t4.COLS)
    assert p.kblocks == -(-K2 // t4.STAGE_ROWS)
    # no split is empty, and the splits cover K
    assert (p.splits - 1) * p.kps < p.kblocks <= p.splits * p.kps
    assert p.units == p.row_blocks * p.col_tiles * p.splits
    assert p.row_blocks * p.bt >= T > (p.row_blocks - 1) * p.bt
    assert p.part_floats == (0 if p.splits == 1 else
                             p.splits * p.tiles * p.bt * t4.COLS)


def test_plan_fits_shared_memory_and_the_card():
    """Every row block's ring fits a block's shared memory on the
    swizzle's 1024-byte boundaries, with as many stages as fit, up to
    MAX_STAGES; a plan never has more CTAs than units or SMs."""
    for bt in t4.DECODE_ROWS + t4.PREFILL_ROWS:
        stage, n = t4.stage_bytes(bt), t4.ring_stages(bt)
        assert stage % 1024 == 0 and n >= 3
        assert 1024 + n * stage <= t4.SMEM_LIMIT
        assert n == t4.MAX_STAGES or 1024 + (n + 1) * stage > t4.SMEM_LIMIT
    rng = np.random.default_rng(1)
    for _ in range(200):
        T, K2, N = (int(v) for v in rng.integers(1, [1500, 5000, 20000]))
        sms = int(rng.integers(1, 140))
        p = t4.plan(T, K2, N, sms)
        assert 1 <= p.ctas <= min(p.units, sms)
        assert 1 <= p.splits <= t4.MAX_SPLITS
        assert (p.splits - 1) * p.kps < p.kblocks <= p.splits * p.kps
        assert p.smem == 1024 + p.stages * t4.stage_bytes(p.bt)
        assert (p.regime == "decode") == (T <= t4.DECODE_MAX_ROWS)


def test_nibble_widening_is_exact():
    """The kernel's widening without a conversion (csrc/w4_matmul.cu,
    `nibbles_bf16`): for every byte, (w & 0xF) ^ 0x4308 read as bf16 is
    136 + n for its signed low nibble n, and (w >> 4) the same for the high
    one; subtracting 136 in bf16 leaves n exactly, as unpack_nibbles has
    it."""
    src = (Path(t4.__file__).parents[1] / "csrc" / "w4_matmul.cu").read_text()
    # one lop3 of (w, 0x000F000F, 0x43084308) with the table of (a & b) ^ c
    assert ('"lop3.b32 %0, %1, %2, %3, 0x6a;' in src
            and '"r"(w), "r"(0x000F000Fu), "r"(0x43084308u)' in src)
    assert (0xF0 & 0xCC) ^ 0xAA == 0x6A
    assert '"r"(0x3F803F80u), "r"(0xC308C308u)' in src   # fma by 1, -136
    b = torch.arange(256, dtype=torch.int32)
    want_lo, want_hi = t4.unpack_nibbles(b.to(torch.uint8).view(torch.int8)[:, None])

    def widen(w):
        bits = ((w & 0xF) ^ 0x4308).to(torch.int16)
        v = bits.view(torch.bfloat16)
        one = torch.tensor(1.0, dtype=torch.bfloat16)
        c = torch.tensor(-136.0, dtype=torch.bfloat16)
        assert c.view(torch.int16).item() == 0xC308 - 0x10000
        return (v * one + c).float()

    assert torch.equal(widen(b), want_lo[:, 0].float())
    assert torch.equal(widen(b >> 4), want_hi[:, 0].float())


def test_variant_edits_apply_to_the_source():
    """Each diagnostic edit of lavida_mod_tpu_torch/w4_matmul_variants.py
    finds its text exactly once in csrc/w4_matmul.cu, so the variants
    build what they say; a forced plan keeps the kernel's checks."""
    import importlib.util

    root = Path(t4.__file__).parents[1]
    spec = importlib.util.spec_from_file_location(
        "w4_matmul_variants", root / "w4_matmul_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    src = (root / "csrc" / "w4_matmul.cu").read_text()
    for name, edits in variants.EDITS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old[:60])
    p = variants.forced_plan(t4, 1056, 2048, 12288, 132, bt=256, splits=2)
    assert (p.bt, p.row_blocks, p.splits, p.kps) == (256, 5, 2, 16)
    assert p.smem == 1024 + t4.ring_stages(256) * t4.stage_bytes(256)
    d = variants.forced_plan(t4, 32, 2048, 12288, 132, bt=256, splits=4)
    assert (d.bt, d.splits, d.kps, d.ctas) == (32, 4, 8, 132)


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_inputs(device, T, K, N, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(T, K, generator=g, device=device).bfloat16()
    codes = torch.randint(-8, 8, (K, N), generator=g, device=device)
    packed = torch.from_numpy(tq.pack_w4(codes.cpu().numpy())).to(device)
    scale = torch.rand(N, generator=g, device=device) + 0.5
    return t4.split_even_odd(x), packed, scale


@pytest.mark.parametrize("T,K,N", [
    (32, 4096, 12288),       # the TPU status note's decode shape (4 splits)
    (1056, 4096, 12288),     # the prefill's rows (row blocks of 256)
    (5, 4304, 1000),         # no dimension a multiple of a tile (12 splits)
    (1, 16, 8),
    (1, 4096, 12288),        # the decode plan's smallest row block
    (8, 4096, 12288),
    (64, 4096, 12288),       # the decode plan's last row count
    (65, 4096, 12288),       # the prefill plan's first (rows of 128)
    (256, 4096, 12288),      # the wgmma's widest N, split
    (300, 4096, 1000),       # a ragged row block, N % 16 = 8, 5 splits
    (32, 4096, 1000),        # the decode plan split (N % 16 = 8)
    (3, 38, 37),             # K/2 odd (2-byte x loads), N odd (byte loads)
    (70, 200, 24),           # K/2 = 100: a partial stage, 8-byte granules
])
def test_kernel_matches_plain_on_cuda(cuda, T, K, N):
    x2, packed, scale = _card_inputs(cuda, T, K, N)
    before = t4.w4_matmul.launches
    out = t4.w4_matmul(x2, packed, scale)
    torch.cuda.synchronize()
    assert t4.w4_matmul.launches == before + 1
    _ulp_close(out, t4.w4_matmul_reference(x2, packed, scale), x2, packed,
               scale)


@pytest.mark.parametrize("T,K,N", [(32, 4096, 12288), (5, 4304, 1000),
                                   (300, 4096, 1000), (1056, 4096, 12288)])
def test_kernel_repeats_its_bits_on_cuda(cuda, T, K, N):
    """Two calls give the same bits: the split partials are added in
    split order, whichever split finishes last."""
    x2, packed, scale = _card_inputs(cuda, T, K, N, seed=1)
    first = t4.w4_matmul(x2, packed, scale)
    for _ in range(3):
        again = t4.w4_matmul(x2, packed, scale)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), again.view(torch.int16))


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
