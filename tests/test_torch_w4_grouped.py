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
On the card the wrapper takes one of two kernels by the row count alone:
T <= 256 the decode kernel (laid out by `decode_plan`), more rows the
prefill kernel (laid out by `prefill_plan`); the CUDA source mirrors both
plans' constants.  The CPU tests pin the dispatch and the plans; both
kernels are held to the plain version, bit for bit, by the tests that need
a card (skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_w4_grouped.py
"""

import re
from pathlib import Path

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
    f = tg.w4_matmul_grouped
    before = (f.launches, f.decode_launches, f.prefill_launches)
    _port(_inputs(0, *CASES[0]), CASES[0][3])
    for T in (256, 257):      # one row count of each regime
        _port(_inputs(1, T, 256, 512, 512), 512)
    assert (f.launches, f.decode_launches, f.prefill_launches) == before


# ---------------------------------------------------------------------------
# the dispatch and the decode kernel's plan
# ---------------------------------------------------------------------------

def test_regime_is_chosen_by_rows_alone():
    """T <= 256 rows take the decode kernel, T >= 257 the prefill kernel
    (pallas_w4.py:179-182 keeps block_t = T up to the same 256)."""
    assert tg.DECODE_MAX_ROWS == 256
    assert [tg.regime(T) for T in (1, 32, 128, 255, 256)] == ["decode"] * 5
    assert [tg.regime(T) for T in (257, 1024, 2304, 4608)] == ["prefill"] * 4


def test_decode_plan_constants_match_the_cuda_source():
    """The plan's constants are the ones csrc/w4_grouped.cu checks a plan
    against, and every rb the plan can choose has its wgmma instance."""
    src = (Path(tg.__file__).parents[1] / "csrc" / "w4_grouped.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m[1])

    assert const("kDecMaxRows") == tg.DECODE_MAX_ROWS
    assert const("kDecSG") == tg.DECODE_SLICE_GROUPS
    assert const("kDecMaxStages") == tg.DECODE_MAX_STAGES
    assert const("kDecCols") == tg.DECODE_COLS
    assert const("kDecSBytes") == tg.DECODE_SCALE_BYTES
    assert "constexpr int kDecThreads = 128 + 32;" in src   # one warpgroup
    assert const("kSmemLimit") == tg.SMEM_LIMIT
    for rb in tg.DECODE_RB:   # the warpgroup's wgmma N
        assert f"wgmma.mma_async.sync.aligned.m64n{rb}k32.s32.s8.s8" in src
        assert f"case {rb}:" in src or rb == tg.DECODE_RB[-1]


# (T, K, N) -> (rb, row_blocks, ctas) on 132 SMs: the B = 4 decode's three
# linears, the B = 8 decode, the B = 8 head, B = 1, a tiny and a Dream width
PLANS = [((128, 4096, 4096), (64, 2, 128)), ((128, 4096, 12288), (64, 2, 132)),
         ((128, 12288, 4096), (64, 2, 128)), ((256, 4096, 4096), (64, 4, 132)),
         ((256, 4096, 12288), (64, 4, 132)), ((256, 12288, 4096), (64, 4, 132)),
         ((256, 4096, 126464), (64, 4, 132)), ((32, 4096, 4096), (16, 2, 128)),
         ((77, 768, 1024), (16, 5, 80)), ((64, 18944, 3584), (32, 2, 112)),
         ((40, 4096, 576), (16, 3, 27))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_decode_plan(shape, want):
    T, K, N = shape
    N = -(-N // 64) * 64
    p = tg.decode_plan(T, N, 132)
    assert (p.rb, p.row_blocks, p.ctas) == want
    assert p.rb in tg.DECODE_RB
    assert p.row_blocks * p.rb >= T > (p.row_blocks - 1) * p.rb   # none empty
    assert p.units == N // tg.DECODE_COLS * p.row_blocks
    owned = [p.owned(c) for c in range(p.ctas)]
    assert [u for r in owned for u in r] == list(range(p.units))
    assert max(map(len, owned)) == -(-p.units // p.ctas)
    stage = tg.decode_stage_bytes(p.rb)
    assert stage == tg.DECODE_SLICE_GROUPS * (8 * 512 + p.rb * 128) + 1024
    assert stage % 1024 == 0                   # the swizzle's boundary
    assert 2 <= p.stages <= tg.DECODE_MAX_STAGES
    assert p.smem == 1024 + p.stages * stage <= tg.SMEM_LIMIT - 1024
    assert (p.stages + 1) * stage + 1024 > tg.SMEM_LIMIT - 1024 \
        or p.stages == tg.DECODE_MAX_STAGES


def _variants():
    import importlib.util

    root = Path(tg.__file__).parents[1]
    spec = importlib.util.spec_from_file_location(
        "w4_grouped_variants", root / "w4_grouped_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    return variants, (root / "csrc" / "w4_grouped.cu").read_text()


def test_decode_variant_edits_apply_to_the_source():
    """Each diagnostic edit of the decode kernel in
    lavida_mod_tpu_torch/w4_grouped_variants.py finds its text exactly once
    in csrc/w4_grouped.cu, so the variants build what they say."""
    variants, src = _variants()
    for name, edits in variants.DIAGNOSTICS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old[:60])


def test_prefill_variant_edits_apply_to_the_source():
    """The same for the prefill kernel's diagnostic edits, each inside
    `w4_prefill_kernel`."""
    variants, src = _variants()
    body = src[src.index("w4_prefill_kernel("):]
    assert variants.REGIMES["prefill"]["entry"] == "lavida_w4_grouped"
    for name, edits in variants.PREFILL_DIAGNOSTICS.items():
        for edit in edits:     # (text, new) or (first, last, new)
            for old in edit[:-1]:
                assert src.count(old) == 1, (name, old[:60])
                assert old in body or old.startswith("#include") \
                    or old.startswith("constexpr int kPre"), (name, old[:60])


def test_decode_plan_row_blocks_share_their_weights():
    """A CTA's run of units takes the row blocks of a column tile one after
    the other (the later reads of its weights from L2), and at B = 4 and
    8 a unit is 64 rows: 2 and 4 row blocks."""
    for T in (128, 256):
        p = tg.decode_plan(T, 4096, 132)
        assert p.row_blocks == T // 64
        for c in range(p.ctas):
            tiles = [u // p.row_blocks for u in p.owned(c)]
            assert tiles == sorted(tiles)
    with pytest.raises(ValueError):
        tg.decode_plan(257, 4096, 132)


def _cuda_const(name):
    src = (Path(tg.__file__).parents[1] / "csrc" / "w4_grouped.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m[1])


def test_prefill_plan_constants_match_the_cuda_source():
    """The prefill plan's constants are the ones csrc/w4_grouped.cu checks
    a plan against; its two consumer warpgroups of one wgmma M each make
    the unit's columns, the wgmma N its rows."""
    src = (Path(tg.__file__).parents[1] / "csrc" / "w4_grouped.cu").read_text()
    assert _cuda_const("kPreRows") == tg.PREFILL_ROWS
    assert _cuda_const("kPreCols") == tg.PREFILL_COLS == 2 * 64
    assert _cuda_const("kPreSG") == tg.PREFILL_SLICE_GROUPS
    assert _cuda_const("kPreMaxStages") == tg.PREFILL_MAX_STAGES
    assert _cuda_const("kPreSBytes") == tg.PREFILL_SCALE_BYTES
    assert _cuda_const("kPreConsumers") == 256           # two warpgroups
    assert "constexpr int kPreThreads = kPreConsumers + 128;" in src
    assert _cuda_const("kSmemLimit") == tg.SMEM_LIMIT
    assert (f"wgmma.mma_async.sync.aligned.m64n{tg.PREFILL_ROWS}k32.s32.s8.s8"
            in src)
    # the producer warpgroup hands its registers over: 128 x 24 + 256 x
    # 240 = 384 x 168, the count the build is held to
    from lavida_mod_tpu_torch import kernels
    assert kernels.REGISTERS_AT_ENTRY["w4_prefill_kernel"] == 168
    assert "setmaxnreg.dec.sync.aligned.u32 24;" in src
    assert "setmaxnreg.inc.sync.aligned.u32 240;" in src
    with pytest.raises(ValueError):
        tg.prefill_plan(256, 4096, 132)
    with pytest.raises(ValueError):
        tg.prefill_plan(4608, 4000, 132)


@pytest.mark.parametrize("N", [4096, 12288, 126464, 576])
@pytest.mark.parametrize("T", [257, 2304, 4608])
def test_prefill_plan(T, N):
    """The units cover T and N once each (the last row block ragged, the
    last column tile half empty at N % 128 = 64), each CTA owns every
    ctas-th unit, and the ring is as deep as shared memory allows."""
    p = tg.prefill_plan(T, N, 132)
    assert p.row_blocks * tg.PREFILL_ROWS >= T > (p.row_blocks - 1) * tg.PREFILL_ROWS
    assert p.col_tiles * tg.PREFILL_COLS >= N > (p.col_tiles - 1) * tg.PREFILL_COLS
    assert p.units == p.col_tiles * p.row_blocks
    assert p.ctas == min(p.units, 132)
    owned = sorted(u for c in range(p.ctas) for u in p.owned(c))
    assert owned == list(range(p.units))
    assert max(len(p.owned(c)) for c in range(p.ctas)) == -(-p.units // p.ctas)
    stage = tg.prefill_stage_bytes()
    assert stage == tg.PREFILL_SLICE_GROUPS * (16 * 512 + 128 * 128 + 512)
    assert stage % 1024 == 0                   # the swizzle's boundary
    assert 2 <= p.stages <= tg.PREFILL_MAX_STAGES
    assert p.smem == 1024 + p.stages * stage <= tg.SMEM_LIMIT - 1024
    assert (p.stages + 1) * stage + 1024 > tg.SMEM_LIMIT - 1024 \
        or p.stages == tg.PREFILL_MAX_STAGES


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


def _card_weights(K, N, g, dev):
    """Random int4 codes in [-8, 7] (the whole nibble range) in the
    fragment layout and positive group scales, at any K (no K pad)."""
    codes = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand(K // tq.GROUP, N, generator=g, device=dev) * 0.01 \
        + 1e-4
    return tq.pack_w4_frag(codes), scales


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 12288), (12288, 4096)])
@pytest.mark.parametrize("T", [32, 64, 96, 128, 160, 224, 256])
def test_decode_kernel_bit_equal_to_plain_on_cuda(cuda, T, K, N):
    g = torch.Generator(device=cuda).manual_seed(T + K + N)
    packed, scales = _card_weights(K, N, g, cuda)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    before = tg.w4_matmul_grouped.decode_launches
    out = tg.w4_matmul_grouped(x, packed, scales)
    torch.cuda.synchronize()
    assert tg.w4_matmul_grouped.decode_launches == before + 1
    assert torch.equal(out, tg.w4_matmul_grouped_reference(x, packed, scales))


@pytest.mark.parametrize("T,K,N,gb", [
    (256, 4096, 126464, 32),     # the B = 8 head
    (77, 768, 576, 2),           # a tiny width, ragged: 3 k-blocks of 2
    (64, 18944, 3584, 4),        # a Dream width: 37 k-blocks of 4 groups
    (5, 384, 512, 1)])           # an odd group count: a half-empty stage
def test_decode_kernel_odd_widths_on_cuda(cuda, T, K, N, gb):
    assert tg.groups_per_kblock(K) == gb
    g = torch.Generator(device=cuda).manual_seed(1)
    packed, scales = _card_weights(K, -(-N // 64) * 64, g, cuda)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    before = tg.w4_matmul_grouped.decode_launches
    out = tg.w4_matmul_grouped(x, packed, scales)
    torch.cuda.synchronize()
    assert tg.w4_matmul_grouped.decode_launches == before + 1
    assert torch.equal(out, tg.w4_matmul_grouped_reference(x, packed, scales))


def test_decode_kernel_chained_calls_on_cuda(cuda):
    """20 calls back to back without a sync, new data at the same input
    address each time (the tensor maps are cached by address)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    packed, scales = _card_weights(4096, 4096, g, cuda)
    xs = [torch.randn(128, 4096, generator=g, device=cuda).bfloat16()
          for _ in range(20)]
    buf = torch.empty_like(xs[0])
    outs = []
    for x in xs:
        buf.copy_(x)
        outs.append(tg.w4_matmul_grouped(buf, packed, scales))
    torch.cuda.synchronize()
    for x, out in zip(xs, outs):
        assert torch.equal(out, tg.w4_matmul_grouped_reference(
            x, packed, scales))


def test_regime_edge_on_cuda(cuda):
    """256 rows take the decode kernel and 257 the prefill kernel; both
    are exact."""
    g = torch.Generator(device=cuda).manual_seed(3)
    packed, scales = _card_weights(4096, 4096, g, cuda)
    f = tg.w4_matmul_grouped
    for T, kind in [(256, "decode"), (257, "prefill")]:
        x = torch.randn(T, 4096, generator=g, device=cuda).bfloat16()
        before = (f.decode_launches, f.prefill_launches)
        out = f(x, packed, scales)
        torch.cuda.synchronize()
        after = (f.decode_launches, f.prefill_launches)
        assert after == (before[0] + (kind == "decode"),
                         before[1] + (kind == "prefill"))
        assert torch.equal(out, tg.w4_matmul_grouped_reference(
            x, packed, scales))


@pytest.mark.parametrize("T,K,N,gb", [
    (257, 4096, 4096, 32),       # one row past the decode regime
    (1153, 4096, 12288, 32),     # ragged: 9 row blocks and one row
    (4608 + 17, 4096, 4096, 32),  # the B = 4 prefill and a ragged block
    (1153, 12288, 4096, 32),     # three k-blocks
    (300, 18944, 3584, 4),       # a Dream width: 37 k-blocks of 4 groups
    (1153, 4096, 576, 32),       # N % 128 = 64: a half-empty column tile
    (513, 768, 576, 2)])         # 3 k-blocks of 2 groups, three slices
def test_prefill_kernel_bit_equal_to_plain_on_cuda(cuda, T, K, N, gb):
    assert tg.groups_per_kblock(K) == gb and tg.regime(T) == "prefill"
    g = torch.Generator(device=cuda).manual_seed(T + K + N)
    packed, scales = _card_weights(K, N, g, cuda)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    before = tg.w4_matmul_grouped.prefill_launches
    out = tg.w4_matmul_grouped(x, packed, scales)
    torch.cuda.synchronize()
    assert tg.w4_matmul_grouped.prefill_launches == before + 1
    assert torch.equal(out, tg.w4_matmul_grouped_reference(x, packed, scales))


def test_prefill_kernel_chained_calls_on_cuda(cuda):
    """10 calls back to back without a sync, each after its row pass (the
    launch overlaps it), new data at the same input address each time and
    two weights in turns (the tensor maps are cached by address)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    ws = [_card_weights(4096, 4096, g, cuda) for _ in range(2)]
    xs = [torch.randn(1153, 4096, generator=g, device=cuda).bfloat16()
          for _ in range(10)]
    buf = torch.empty_like(xs[0])
    outs = []
    for i, x in enumerate(xs):
        buf.copy_(x)
        outs.append(tg.w4_matmul_grouped(buf, *ws[i % 2]))
    torch.cuda.synchronize()
    for i, (x, out) in enumerate(zip(xs, outs)):
        assert torch.equal(out, tg.w4_matmul_grouped_reference(x, *ws[i % 2]))


def test_prefill_rejects_a_plan_that_does_not_match_on_cuda(cuda):
    from lavida_mod_tpu_torch import kernels

    T, K, N = 1024, 4096, 4096
    x8 = torch.zeros(T, K, dtype=torch.int8, device=cuda)
    sx = torch.ones(T, device=cuda)
    packed = torch.zeros(N // 8, K // 128, 512, dtype=torch.uint8,
                         device=cuda)
    scales = torch.ones(K // 128, N, device=cuda)
    out = torch.empty(T, N, dtype=torch.bfloat16, device=cuda)
    p = tg.prefill_plan(T, N, 132)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x8.data_ptr(), sx.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), out.data_ptr())
    lib = kernels.library()
    good = (p.col_tiles, p.row_blocks, p.ctas, p.stages, p.smem)
    assert lib.lavida_w4_grouped(*ptrs, T, K, N, 32, *good, stream) == 0
    for bad in [(p.col_tiles, p.row_blocks, p.ctas, p.stages, p.smem + 1024),
                (p.col_tiles + 1, p.row_blocks, p.ctas, p.stages, p.smem),
                (p.col_tiles, p.row_blocks - 1, p.ctas, p.stages, p.smem),
                (p.col_tiles, p.row_blocks, p.units + 1, p.stages, p.smem),
                (p.col_tiles, p.row_blocks, p.ctas,
                 tg.PREFILL_MAX_STAGES + 1, p.smem)]:
        assert lib.lavida_w4_grouped(*ptrs, T, K, N, 32, *bad, stream) != 0
    # the decode regime's rows are not the prefill kernel's
    assert lib.lavida_w4_grouped(*ptrs, 256, K, N, 32, p.col_tiles, 2,
                                 p.ctas, p.stages, p.smem, stream) != 0
    torch.cuda.synchronize()


def test_decode_rejects_a_plan_that_does_not_match_on_cuda(cuda):
    from lavida_mod_tpu_torch import kernels

    T, K, N = 128, 4096, 4096
    x8 = torch.zeros(T, K, dtype=torch.int8, device=cuda)
    sx = torch.ones(T, device=cuda)
    packed = torch.zeros(N // 8, K // 128, 512, dtype=torch.uint8,
                         device=cuda)
    scales = torch.ones(K // 128, N, device=cuda)
    out = torch.empty(T, N, dtype=torch.bfloat16, device=cuda)
    p = tg.decode_plan(T, N, 132)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x8.data_ptr(), sx.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), out.data_ptr())
    for bad in [(p.rb, p.row_blocks, p.ctas, p.stages, p.smem + 1024),
                (24, p.row_blocks, p.ctas, p.stages, p.smem),
                (p.rb, 1, p.ctas, p.stages, p.smem),
                (p.rb, p.row_blocks, p.units + 1, p.stages, p.smem),
                (p.rb, p.row_blocks, p.ctas, tg.DECODE_MAX_STAGES + 1, p.smem)]:
        assert kernels.library().lavida_w4_grouped_decode(
            *ptrs, T, K, N, 32, *bad, stream) != 0


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
