"""The port's fused W4A8 decode ops (lavida_mod_tpu_torch.ops.w4_fused)
against the JAX package's Pallas kernels run in interpret mode on the CPU,
at the shapes of tests/test_w4_fused.py.

On a CPU tensor each wrapper runs its plain PyTorch version.
  - In this process (XLA's default excess precision) the plain versions
    stay inside tests/test_w4_fused.py's bands: 2 % for one stage, 3 % for
    the FFN chain (max |diff| / max |ref|).
  - With excess precision off (tests/torch_jax_strict.py), where XLA keeps
    every bf16 rounding the kernels write, qkv_norm and matmul_res are
    bit-exact.  The FFN's SwiGLU takes XLA's logistic on one side and
    1 / (1 + exp(-g)) on the other; they differ in the last bit for a few
    inputs, and a bf16 intermediate that rounds the other way can move an
    activation code by one: 1 % of max |ref| bounds that.
The CUDA kernels are held to the plain versions on the card by the tests
that need one (skipped without), at the LLaDA-8B decode shapes:
    python -m pytest --noconftest -k cuda tests/test_torch_w4_fused.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.ops import quant as tq
from lavida_mod_tpu_torch.ops import w4_fused as tw
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

TOL, TOL_CHAIN = 0.02, 0.03

# (op, shape args) -- tests/test_w4_fused.py's cases
CASES = [
    ("qkv", dict(T=32, D=256, N=384)),
    ("qkv", dict(T=16, D=512, N=1024)),
    ("res", dict(T=32, K=256, N=256)),
    ("res", dict(T=32, K=384, N=128)),
    ("ffn", dict(T=32, D=256, H=384, Hd=384)),
    ("ffn", dict(T=32, D=512, H=512, Hd=512)),
    ("ffn", dict(T=32, D=256, H=384, Hd=512)),     # padded down K
    ("ffn", dict(T=16, D=512, H=1536, Hd=1536)),   # the 8B block structure
]


def _bf16(a):
    """f32 values that bf16 represents exactly (both frameworks read them
    without rounding)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _w4(rng, K, N, Kp=None):
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    if Kp is not None:
        w = np.pad(w, ((0, Kp - K), (0, 0)))
    return tq.quantize_w4_grouped(w)


def _inputs(op, seed, T, **d):
    rng = np.random.default_rng(seed)
    if op == "qkv":
        packed, scales = _w4(rng, d["D"], d["N"])
        return dict(x=_bf16(rng.standard_normal((T, d["D"]))),
                    nw=_bf16(rng.standard_normal(d["D"])),
                    packed=packed, scales=scales)
    if op == "res":
        packed, scales = _w4(rng, d["K"], d["N"])
        return dict(a=_bf16(rng.standard_normal((T, d["K"]))),
                    res=_bf16(rng.standard_normal((T, d["N"]))),
                    packed=packed, scales=scales)
    up_p, up_s = _w4(rng, d["D"], 2 * d["H"])
    dn_p, dn_s = _w4(rng, d["H"], d["D"], d["Hd"])
    return dict(x=_bf16(rng.standard_normal((T, d["D"]))),
                nw=_bf16(1.0 + 0.1 * rng.standard_normal(d["D"])),
                up_p=up_p, up_s=up_s, dn_p=dn_p, dn_s=dn_s)


def _port(op, a):
    b = lambda k: torch.from_numpy(a[k]).bfloat16()        # noqa: E731
    f = lambda k: torch.from_numpy(tq.unpack_w4_jax(a[k]))  # noqa: E731
    w = lambda k: tq.pack_w4_frag(f(k))                     # noqa: E731
    s = lambda k: torch.from_numpy(a[k])                    # noqa: E731
    if op == "qkv":
        out = tw.w4_qkv_norm(b("x"), b("nw"), w("packed"), s("scales"), 1e-5)
    elif op == "res":
        out = tw.w4_matmul_res(b("a"), b("res"), w("packed"), s("scales"))
    else:
        out = tw.w4_ffn_fused(b("x"), b("nw"), w("up_p"), s("up_s"),
                              w("dn_p"), s("dn_s"), 1e-5)
    return out.float().numpy()


# the JAX side, as code so it can also run in the strict child process
JAX_CASE = """
import jax.numpy as jnp
from lavida_mod_tpu.ops.w4_fused import w4_ffn_fused, w4_matmul_res, w4_qkv_norm

def jax_case(op, a):
    b = lambda k: jnp.asarray(a[k], jnp.bfloat16)
    j = lambda k: jnp.asarray(a[k])
    if op == "qkv":
        out = w4_qkv_norm(b("x"), b("nw"), j("packed"), j("scales"),
                          eps=1e-5, block_n=128, interpret=True)
    elif op == "res":
        out = w4_matmul_res(b("a"), b("res"), j("packed"), j("scales"),
                            block_n=128, interpret=True)
    else:
        out = w4_ffn_fused(b("x"), b("nw"), j("up_p"), j("up_s"), j("dn_p"),
                           j("dn_s"), eps=1e-5, block_n=128, interpret=True)
    return np.asarray(out.astype(jnp.float32))
"""


def _rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_within_band_of_jax_kernel(i):
    ns = {"np": np}
    exec(JAX_CASE, ns)
    op, d = CASES[i]
    a = _inputs(op, i, **d)
    got, want = _port(op, a), ns["jax_case"](op, a)
    assert got.shape == want.shape
    assert _rel_err(got, want) < (TOL_CHAIN if op == "ffn" else TOL)


def test_plain_bit_exact_without_excess_precision(tmp_path):
    inputs = {}
    for i, (op, d) in enumerate(CASES):
        inputs.update({f"{i}/{k}": v for k, v in _inputs(op, i, **d).items()})
    ref = strict_jax(JAX_CASE + f"""
CASES = {[op for op, _ in CASES]!r}
for i, op in enumerate(CASES):
    a = {{k.split("/", 1)[1]: v for k, v in IN.items()
         if k.startswith(f"{{i}}/")}}
    OUT[str(i)] = jax_case(op, a)
""", tmp_path, inputs)
    for i, (op, d) in enumerate(CASES):
        got = _port(op, _inputs(op, i, **d))
        if op == "ffn":
            assert _rel_err(got, ref[str(i)]) < 0.01, (op, d)
        else:
            np.testing.assert_array_equal(got, ref[str(i)],
                                          err_msg=f"{op} {d}")


def test_group_dot_acc_order():
    """`group_dot_acc` adds d_g * s_g group by group into an f32
    accumulator: bit-equal to that loop written out, and NOT in general to
    the one-contraction form of `_linear_w4`'s CPU path."""
    rng = np.random.default_rng(3)
    packed, scales = _w4(rng, 1024, 256)
    x8 = torch.from_numpy(rng.integers(-127, 128, (8, 1024)).astype(np.int8))
    w = torch.from_numpy(tq.unpack_w4_jax(packed)).long()
    s = torch.from_numpy(scales)
    want = torch.zeros(8, 256)
    for g in range(8):
        d = (x8[:, g * 128:(g + 1) * 128].long()
             @ w[g * 128:(g + 1) * 128]).float()
        want = want + d * s[g]
    got = tw.group_dot_acc(x8, tq.pack_w4_frag(w.to(torch.int8)), s)
    assert torch.equal(got, want)


def test_cpu_routes_count_no_launch():
    a = _inputs("ffn", 0, **CASES[4][1])
    before = (tw.w4_qkv_norm.launches, tw.w4_matmul_res.launches,
              tw.w4_ffn_fused.launches)
    _port("ffn", a)
    _port("qkv", _inputs("qkv", 0, **CASES[0][1]))
    _port("res", _inputs("res", 2, **CASES[2][1]))
    assert (tw.w4_qkv_norm.launches, tw.w4_matmul_res.launches,
            tw.w4_ffn_fused.launches) == before


# the plan of w4_ffn_fused's GEMMs: the 8B decode shape at every row count
# the fused plan takes (and one above it), Dream-7B's (28 groups: a ragged
# last slice of the up GEMM; H 18944 read through 20480 padded down rows),
# and the FFN cases above
PLAN_CASES = [(T, 4096, 12288, 12288) for T in (8, 16, 24, 32, 40)] + [
    (T, 3584, 18944, 20480) for T in (8, 32, 40)] + [
    (d["T"], d["D"], d["H"], d["Hd"]) for op, d in CASES if op == "ffn"]


@pytest.mark.parametrize("T,D,H,Hd", PLAN_CASES)
def test_ffn_plan_owns_every_tile_once_within_shared_memory(T, D, H, Hd):
    for sms in (132, 114, 78):
        plan = tw.ffn_plan(T, D, H, Hd, sms)
        assert plan.row_slices == -(-T // 32)
        for g, tiles, pair in ((plan.up, 2 * H // 8, H // 8),
                               (plan.down, D // 8, 0)):
            owned = sorted(u + t * pair for c in range(g.ctas)
                           for u in g.owned(c) for t in range(g.tiles))
            assert owned == list(range(tiles)), (sms, g)
            assert min(g.units, sms) <= g.ctas <= g.units
            assert g.smem <= tw.SMEM_LIMIT == 232448
            # the ring keeps the in-flight minimum while one stage is read
            assert tw.MIN_STAGES <= g.stages <= tw.MAX_STAGES
            assert (g.stages - 1) * g.stage_bytes >= tw.IN_FLIGHT_MIN
        # the scratch regions do not overlap and hold their contents
        sizes = [tw.slice_bytes(plan.up.slice_groups, D // 128),
                 tw.slice_bytes(plan.down.slice_groups, Hd // 128),
                 2 * 32 * H, 128, 128, 128]
        ends = list(plan.offsets[1:]) + [plan.work_bytes]
        for off, end, n in zip(plan.offsets, ends, sizes):
            assert off % 128 == 0 and end - off >= n


# the plan of w4_qkv_norm's GEMM: [q|k|v] and the head of the 8B at every
# row count of the decode paths (and one above a 32-row slice), Dream-7B's
# [q|k|v] and its head padded to 152064 columns, the tiny mixed models'
# [q|k|v] and head widths, and the other cases of this file
QKV_PLAN_CASES = [(T, 4096, N) for N in (12288, 126464)
                  for T in (8, 16, 24, 32, 40, 128)] + [
    (T, 3584, N) for N in (4608, 152064) for T in (8, 32, 40)] + [
    (32, 512, 1536), (32, 512, 512), (32, 4096, 13600), (8, 384, 96),
    (40, 256, 160), (40, 384, 160)] + [
    (d["T"], d["D"], d["N"]) for op, d in CASES if op == "qkv"]


@pytest.mark.parametrize("T,D,N", QKV_PLAN_CASES)
def test_qkv_plan_owns_every_tile_once_within_shared_memory(T, D, N):
    G = D // 128
    for sms in (132, 114, 78):
        plan = tw.qkv_plan(T, D, N, sms)
        g = plan.gemm
        assert plan.row_slices == -(-T // 32)
        owned = sorted(u for c in range(g.ctas) for u in g.owned(c))
        assert owned == list(range(N // 8)), (sms, g)
        assert g.tiles == 1 and min(g.units, sms) <= g.ctas <= g.units
        # what lavida_w4_qkv_norm recomputes from its constants
        sg, pu = tw.QKV_SLICE_GROUPS, tw.QKV_PASS_UNITS
        stage = 32 * (sg * 128 + 16) + pu * sg * 512
        max_units = -(-g.units // g.ctas)
        assert (g.slice_groups, g.stage_bytes) == (sg, stage)
        assert g.smem == 128 + G * max_units * 32 + g.stages * stage
        assert g.smem <= tw.SMEM_LIMIT == 232448
        assert tw.MIN_STAGES <= g.stages <= tw.MAX_STAGES
        assert (g.stages - 1) * g.stage_bytes >= tw.IN_FLIGHT_MIN
        # the codes of 32 rows in the slice layout, then sx [32]
        sizes = [tw.slice_bytes(sg, G), 128]
        ends = list(plan.offsets[1:]) + [plan.work_bytes]
        for off, end, n in zip(plan.offsets, ends, sizes):
            assert off % 128 == 0 and end - off >= n


# the plan of w4_matmul_res's GEMM: the 8B's attention output projection,
# the tiny mixed model's, Qwen2-7B's width (28 groups: a ragged last slice)
# and a narrow case, at 1 to 128 rows
RES_PLAN_CASES = [(T, K, N) for K, N in ((4096, 4096), (512, 512),
                                         (3584, 3584), (384, 96))
                  for T in (1, 8, 32, 40, 128)]


@pytest.mark.parametrize("T,K,N", RES_PLAN_CASES)
def test_res_plan_owns_every_tile_once_within_shared_memory(T, K, N):
    G = K // 128
    sg, pu = tw.RES_SLICE_GROUPS, tw.RES_PASS_UNITS
    for sms in (132, 114, 78):
        plan = tw.res_plan(T, K, N, sms)
        g = plan.gemm
        assert plan.row_slices == -(-T // 32)
        owned = sorted(u for c in range(g.ctas) for u in g.owned(c))
        assert owned == list(range(N // 8)), (sms, g)
        assert g.tiles == 1 and 1 <= g.ctas <= min(g.units, sms)
        # the longest CTA takes as many passes as with one CTA per SM, and
        # one CTA fewer would take more
        max_units = -(-g.units // g.ctas)
        passes = -(-(-(-g.units // sms)) // pu)
        assert -(-max_units // pu) == passes
        assert g.ctas == 1 or -(-g.units // (g.ctas - 1)) > passes * pu
        # what lavida_w4_matmul_res recomputes from its constants
        stage = 32 * (sg * 128 + 16) + pu * sg * 512
        assert (g.slice_groups, g.stage_bytes) == (sg, stage)
        assert g.smem == 128 + G * max_units * 32 + g.stages * stage
        assert g.smem <= tw.SMEM_LIMIT == 232448
        assert tw.MIN_STAGES <= g.stages <= tw.MAX_STAGES
        assert (g.stages - 1) * g.stage_bytes >= tw.IN_FLIGHT_MIN
        # the codes of 32 rows in the slice layout, then sa [32]
        sizes = [tw.slice_bytes(sg, G), 128]
        ends = list(plan.offsets[1:]) + [plan.work_bytes]
        for off, end, n in zip(plan.offsets, ends, sizes):
            assert off % 128 == 0 and end - off >= n
    # at the 8B's shape on an H100 SXM: 128 CTAs of 4 tiles, one pass each
    assert tw.res_plan(32, 4096, 4096, 132).gemm.ctas == 128


@pytest.mark.parametrize("name,sg,pu", [("Qkv", tw.QKV_SLICE_GROUPS,
                                         tw.QKV_PASS_UNITS),
                                        ("Res", tw.RES_SLICE_GROUPS,
                                         tw.RES_PASS_UNITS),
                                        ("Up", tw.UP_SLICE_GROUPS,
                                         tw.UP_PASS_UNITS),
                                        ("Dn", tw.DN_SLICE_GROUPS,
                                         tw.DN_PASS_UNITS)])
def test_plan_constants_match_the_cuda_source(name, sg, pu):
    """The plans' stage shapes are the constants the C entry points check
    a plan against (csrc/w4_fused.cu), and a pass's units split evenly over
    the core's four warp classes (csrc/w4_stream.cuh)."""
    src = (Path(tw.__file__).parents[1] / "csrc" / "w4_fused.cu").read_text()
    m = re.search(rf"k{name}SG = (\d+), k{name}PU = (\d+);", src)
    assert m and (int(m[1]), int(m[2])) == (sg, pu)
    assert pu % 4 == 0 and 2 <= sg <= 32


def test_intermediate_scale_is_a_max_over_column_blocks():
    """The up|gate epilogue raises each row's amax of the bf16
    intermediate with an atomicMax on the bits of a non-negative f32, one
    n8 column block at a time, in whatever order the CTAs finish: the
    resulting sa and codes are the plain version's whatever the order."""
    rng = np.random.default_rng(7)
    T, H = 32, 384
    prod = torch.from_numpy(rng.standard_normal((T, 2 * H)).astype(
        np.float32) * 3).bfloat16()
    prod[5] = 0                                    # an all-zero row
    a8, sa, inter = tw.swiglu_quant(prod)
    blocks = inter.float().abs().split(8, dim=1)
    for _ in range(4):
        bits = torch.zeros(T, dtype=torch.int32)
        for i in rng.permutation(len(blocks)):
            bits = torch.maximum(bits, blocks[i].amax(dim=1).view(torch.int32))
        amax = bits.view(torch.float32)[:, None]
        sa2 = tq._div(torch.clamp_min(amax, 1e-8), 127.0)
        assert torch.equal(sa2, sa)
        q = torch.clamp(torch.round(inter.float() / sa2), -127, 127)
        assert torch.equal(q.to(torch.int8), a8)


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_weights(K, N, gen, device):
    w = torch.randn(N, K, generator=gen, device=device) * 0.02
    packed, scales, _ = tq.quantize_linear4(w)
    return packed, scales


def _check(out, ref, band):
    """Exact up to activation codes that flip on a rounding boundary: the
    kernels reduce the RMSNorm statistics in another order than torch."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = _rel_err(out.float().cpu().numpy(), ref.float().cpu().numpy())
    assert err < band, err
    return err


@pytest.mark.parametrize("T,D,N", [(32, 4096, 12288), (32, 4096, 126464),
                                   (8, 384, 96), (40, 256, 160),
                                   (8, 4096, 126464), (24, 4096, 126464),
                                   (40, 4096, 126464), (128, 4096, 126464),
                                   # 1700 tiles: passes of 12 and 1
                                   (32, 4096, 13600)])
def test_qkv_norm_kernel_matches_plain_on_cuda(cuda, T, D, N):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(T, D, generator=g, device=cuda).bfloat16()
    nw = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).bfloat16()
    packed, scales = _card_weights(D, N, g, cuda)
    scales = scales[:, :N].contiguous()
    packed = packed[:N // 8].contiguous()
    before = tw.w4_qkv_norm.launches
    out = tw.w4_qkv_norm(x, nw, packed, scales, 1e-5)
    torch.cuda.synchronize()
    assert tw.w4_qkv_norm.launches == before + 1
    _check(out, tw.w4_qkv_norm_reference(x, nw, packed, scales, 1e-5), 1e-2)


def test_qkv_norm_back_to_back_on_cuda(cuda):
    """20 calls with no sync between them, each on the output of the one
    before ([32, 4096] x 4096): a GEMM that read the codes before its norm
    pass wrote them (a missing griddepcontrol.wait), or a norm pass that
    overwrote them while the GEMM before read them, shows here.  Then the
    chain again from new data at the same address."""
    D = 4096
    g = torch.Generator(device=cuda).manual_seed(4)
    nw = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).bfloat16()
    w = _card_weights(D, D, g, cuda)
    x0 = torch.empty(32, D, dtype=torch.bfloat16, device=cuda)
    for _ in range(2):
        x0.copy_(torch.randn(32, D, generator=g, device=cuda))
        xs = [x0]
        for _ in range(20):
            xs.append(tw.w4_qkv_norm(xs[-1], nw, *w, 1e-5))
        torch.cuda.synchronize()
        for x, out in zip(xs[:-1], xs[1:]):
            _check(out, tw.w4_qkv_norm_reference(x, nw, *w, 1e-5), 1e-2)


def test_qkv_norm_rejects_a_plan_that_does_not_match_on_cuda(cuda):
    """lavida_w4_qkv_norm recomputes the GEMM's shared bytes from its own
    constants and refuses a plan that does not reproduce them, or whose
    CTAs or stages it cannot run, before it launches anything."""
    from lavida_mod_tpu_torch import kernels

    T, D, N = 32, 4096, 12288
    x = torch.randn(T, D, device=cuda).bfloat16()
    nw = torch.ones(D, dtype=torch.bfloat16, device=cuda)
    packed, scales = _card_weights(D, N, torch.Generator(
        device=cuda).manual_seed(5), cuda)
    plan = tw.qkv_plan(T, D, N, tw._sms(cuda.index or 0))
    work = torch.empty(plan.work_bytes, dtype=torch.uint8, device=cuda)
    out = torch.zeros(T, N, dtype=torch.bfloat16, device=cuda)
    g = plan.gemm

    def call(ctas, stages, smem):
        return kernels.library().lavida_w4_qkv_norm(
            x.data_ptr(), nw.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), work.data_ptr() + plan.offsets[0],
            work.data_ptr() + plan.offsets[1], out.data_ptr(), T, D, N, 1e-5,
            ctas, stages, smem, torch.cuda.current_stream().cuda_stream)

    for bad in [(g.ctas, g.stages, g.smem + 16),
                (g.ctas, g.stages + 1, g.smem),
                (2 * g.ctas, g.stages, g.smem),
                (0, g.stages, g.smem), (N // 8 + 1, g.stages, g.smem),
                (g.ctas, 1, g.smem), (g.ctas, 7, g.smem),
                (g.ctas, g.stages, 232448 + 1024)]:
        assert call(*bad) != 0, bad
    torch.cuda.synchronize()
    assert not out.any()           # nothing ran
    assert call(g.ctas, g.stages, g.smem) == 0
    _check(out, tw.w4_qkv_norm_reference(x, nw, packed, scales, 1e-5), 1e-2)


@pytest.mark.parametrize("T,K,N", [(32, 4096, 4096), (5, 384, 64),
                                   (1, 4096, 4096), (8, 4096, 4096),
                                   (40, 4096, 4096), (128, 4096, 4096),
                                   # 28 groups: a ragged last K-slice
                                   (32, 3584, 3584)])
def test_matmul_res_kernel_matches_plain_on_cuda(cuda, T, K, N):
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    res = torch.randn(T, N, generator=g, device=cuda).bfloat16()
    packed, scales = _card_weights(K, N, g, cuda)
    packed, scales = packed[:N // 8].contiguous(), scales[:, :N].contiguous()
    before = tw.w4_matmul_res.launches
    out = tw.w4_matmul_res(a, res, packed, scales)
    ref = tw.w4_matmul_res_reference(a, res, packed, scales)
    torch.cuda.synchronize()
    assert tw.w4_matmul_res.launches == before + 1
    # same quantization formula, exact group dots, same f32 order
    assert torch.equal(out, ref)


def test_matmul_res_back_to_back_on_cuda(cuda):
    """20 calls with no sync between them, each on the output of the one
    before ([32, 4096] x 4096): a GEMM that read the codes before its quant
    pass wrote them (a missing griddepcontrol.wait), or a quant pass that
    overwrote them while the GEMM before read them, shows here.  Then the
    chain again from new data at the same addresses."""
    K = 4096
    g = torch.Generator(device=cuda).manual_seed(6)
    w = _card_weights(K, K, g, cuda)
    a0 = torch.empty(32, K, dtype=torch.bfloat16, device=cuda)
    res = torch.empty(32, K, dtype=torch.bfloat16, device=cuda)
    for _ in range(2):
        a0.copy_(torch.randn(32, K, generator=g, device=cuda))
        res.copy_(torch.randn(32, K, generator=g, device=cuda))
        outs = [a0]
        for _ in range(20):
            outs.append(tw.w4_matmul_res(outs[-1], res, *w))
        torch.cuda.synchronize()
        for a, out in zip(outs[:-1], outs[1:]):
            assert torch.equal(out, tw.w4_matmul_res_reference(a, res, *w))


def test_matmul_res_rejects_a_plan_that_does_not_match_on_cuda(cuda):
    """lavida_w4_matmul_res recomputes the GEMM's shared bytes from its own
    constants and refuses a plan that does not reproduce them, or whose
    CTAs or stages it cannot run, before it launches anything."""
    from lavida_mod_tpu_torch import kernels

    T, K, N = 32, 4096, 4096
    a = torch.randn(T, K, device=cuda).bfloat16()
    res = torch.randn(T, N, device=cuda).bfloat16()
    packed, scales = _card_weights(K, N, torch.Generator(
        device=cuda).manual_seed(7), cuda)
    packed, scales = packed[:N // 8].contiguous(), scales[:, :N].contiguous()
    plan = tw.res_plan(T, K, N, tw._sms(cuda.index or 0))
    work = torch.empty(plan.work_bytes, dtype=torch.uint8, device=cuda)
    out = torch.zeros(T, N, dtype=torch.bfloat16, device=cuda)
    g = plan.gemm

    def call(ctas, stages, smem):
        return kernels.library().lavida_w4_matmul_res(
            a.data_ptr(), res.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), work.data_ptr() + plan.offsets[0],
            work.data_ptr() + plan.offsets[1], out.data_ptr(), T, K, N,
            ctas, stages, smem, torch.cuda.current_stream().cuda_stream)

    for bad in [(g.ctas, g.stages, g.smem + 16),
                (g.ctas, g.stages + 1, g.smem),
                (g.ctas // 2, g.stages, g.smem),
                (0, g.stages, g.smem), (N // 8 + 1, g.stages, g.smem),
                (g.ctas, 1, g.smem), (g.ctas, 7, g.smem),
                (g.ctas, g.stages, 232448 + 1024)]:
        assert call(*bad) != 0, bad
    torch.cuda.synchronize()
    assert not out.any()           # nothing ran
    assert call(g.ctas, g.stages, g.smem) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, tw.w4_matmul_res_reference(a, res, packed,
                                                       scales))


def _ffn_card_weights(D, H, Hd, gen, device):
    up_p, up_s = _card_weights(D, 2 * H, gen, device)
    w = torch.randn(D, H, generator=gen, device=device) * 0.02
    dn_p, dn_s, _ = tq.quantize_linear4(
        torch.nn.functional.pad(w, (0, Hd - H)))
    return (up_p[:2 * H // 8].contiguous(), up_s[:, :2 * H].contiguous(),
            dn_p[:D // 8].contiguous(), dn_s[:, :D].contiguous())


@pytest.mark.parametrize("T,D,H,Hd", [(8, 4096, 12288, 12288),
                                      (16, 4096, 12288, 12288),
                                      (24, 4096, 12288, 12288),
                                      (32, 4096, 12288, 12288),
                                      (40, 4096, 12288, 12288),
                                      (24, 256, 384, 512)])
def test_ffn_fused_kernel_matches_plain_on_cuda(cuda, T, D, H, Hd):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.empty(T, D, dtype=torch.bfloat16, device=cuda)
    nw = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).bfloat16()
    w = _ffn_card_weights(D, H, Hd, g, cuda)
    # twice, with new data at the same addresses
    for _ in range(2):
        x.copy_(torch.randn(T, D, generator=g, device=cuda))
        before = tw.w4_ffn_fused.launches
        out = tw.w4_ffn_fused(x, nw, *w, 1e-5)
        torch.cuda.synchronize()
        assert tw.w4_ffn_fused.launches == before + 1
        _check(out, tw.w4_ffn_fused_reference(x, nw, *w, 1e-5), 2e-2)


def test_ffn_fused_back_to_back_on_cuda(cuda):
    """20 calls with no sync between them, each on the output of the one
    before: a pass that read its predecessor's output before the
    predecessor finished (a missing griddepcontrol.wait) shows here."""
    D, H = 4096, 12288
    g = torch.Generator(device=cuda).manual_seed(3)
    nw = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).bfloat16()
    w = _ffn_card_weights(D, H, H, g, cuda)
    xs = [torch.randn(32, D, generator=g, device=cuda).bfloat16()]
    for _ in range(20):
        xs.append(tw.w4_ffn_fused(xs[-1], nw, *w, 1e-5))
    torch.cuda.synchronize()
    for x, out in zip(xs[:-1], xs[1:]):
        _check(out, tw.w4_ffn_fused_reference(x, nw, *w, 1e-5), 2e-2)


def test_kernels_reject_bad_shapes_on_cuda(cuda):
    x = torch.zeros(4, 256, dtype=torch.bfloat16, device=cuda)
    packed = torch.zeros(4, 2, 512, dtype=torch.uint8, device=cuda)
    scales = torch.zeros(2, 32, device=cuda)
    with pytest.raises(ValueError):
        tw.w4_qkv_norm(x.float(), x[0], packed, scales)
    with pytest.raises(ValueError):
        tw.w4_matmul_res(x[:, :128], x[:, :32], packed, scales)
