"""The decode attention over the bf16 cache (lavida_mod_tpu_torch.ops.
decode_attention): its plain version, its plan, and the route
`LLaDA.forward` gives it.

  - The plain version agrees with `dense_attention` under make_bias's mask
    (to 2e-6 in f32; in bf16 within 4e-3 + 4e-3 |out|, the rounding of p,
    which dense_attention takes after normalizing and the kernel's order
    before)
    and is `short_attention_reference` under the segment ids (1 for every
    query, the valid byte for every key) bit for bit, for MHA and GQA, T
    of 1, 32 and 64 rows, S not a multiple of the 64-key tile, front-padded
    and unwritten rows masked, and with no mask; a row that sees no key
    averages over every key, as dense_attention's.
  - `decode_plan`'s constants and head dims are the ones
    csrc/decode_attention.cu checks a plan against and is built for, and
    its layouts at the path's shapes are pinned.
  - On the CPU every mode of `LLaDA.forward` attends as before: the
    decode route is taken on the card alone.
The kernel (its key splits included) is held to the plain version, the
routes are counted and one denoised batch is held to the dense route by
the tests that need a card (skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_decode_attention.py
"""

import re
from pathlib import Path

import pytest
import torch

from lavida_mod_tpu_torch.config import tiny_llada_config
from lavida_mod_tpu_torch.generation import diffusion as td
from lavida_mod_tpu_torch.models import llada as tl
from lavida_mod_tpu_torch.models.llada import LLaDA
from lavida_mod_tpu_torch.ops import decode_attention as tda
from lavida_mod_tpu_torch.ops import sampling
from lavida_mod_tpu_torch.ops.attention import dense_attention, make_bias
from lavida_mod_tpu_torch.ops.kv8_attention import kv8_decode_attention
from lavida_mod_tpu_torch.ops.short_attention import (
    short_attention, short_attention_reference)

# bf16: dense_attention rounds the normalized p to bf16, the plain version
# (as the kernel) the unnormalized p; each output, a mean of v rows weighted
# by p and rounded to bf16, moves by about one bf16 ulp (3.9e-3 near 1).
# The kernel rounds p against the running max of its key tiles.
BF16_TOL = 4e-3
F32_TOL = 2e-6


def _inputs(g, B, T, Hq, Hkv, hd, S, pad, dtype, device="cpu"):
    """q [B, T, Hq, hd], k, v [B, S, Hkv, hd] and the [B, S] mask of a
    write-index step: batch row b front-padded by (pad * b) % (S // 3) keys
    (generate_batch's padding), the `pad` rows at the end unwritten."""
    def randn(*shape):
        return torch.randn(*shape, generator=g).to(device, dtype)

    q, k, v = randn(B, T, Hq, hd), randn(B, S, Hkv, hd), randn(B, S, Hkv, hd)
    valid = torch.ones(B, S, dtype=torch.bool)
    for b in range(B):
        valid[b, :(pad * b) % max(S // 3, 1)] = False
    valid[:, S - pad:] = False
    return q, k, v, valid.to(device)


# (B, T, Hq, Hkv, hd, S, pad): MHA and GQA, T 1 / 32 / 64, S not a multiple
# of the 64-key tile, front-padded and unwritten rows
CASES = [(2, 32, 4, 4, 16, 77, 5), (3, 1, 8, 2, 32, 200, 9),
         (2, 64, 8, 2, 64, 130, 17), (1, 32, 4, 1, 128, 64, 0),
         (2, 32, 28, 4, 128, 211, 13), (4, 1, 4, 4, 16, 64, 3),
         (1, 32, 28, 4, 128, 1088, 0)]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_dense_and_short_reference(case, dtype, masked):
    B, T, Hq, Hkv, hd, S, pad = case
    g = torch.Generator().manual_seed(sum(case))
    q, k, v, valid = _inputs(g, B, T, Hq, Hkv, hd, S, pad, dtype)
    if not masked:
        valid = None
    got = tda.decode_attention_reference(q, k, v, valid)
    assert got.dtype == dtype and got.shape == q.shape
    dense = dense_attention(q, k, v, bias=None if valid is None
                            else make_bias(kv_valid=valid))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), dense.float(), atol=tol, rtol=tol)
    seg = () if valid is None else (torch.ones(B, T, dtype=torch.int32),
                                    valid.to(torch.int32))
    assert torch.equal(got, short_attention_reference(q, k, v, *seg))


@pytest.mark.parametrize("S", [70, 128])
def test_plain_row_that_sees_no_key_averages_over_every_key(S):
    g = torch.Generator().manual_seed(1)
    q, k, v, valid = _inputs(g, 2, 4, 4, 2, 32, S, 0, torch.float32)
    valid[1] = False
    got = tda.decode_attention_reference(q, k, v, valid)
    mean = v[1].mean(dim=0).repeat_interleave(2, dim=0)   # [Hq, hd]
    torch.testing.assert_close(got[1], mean.expand(4, 4, 32),
                               atol=F32_TOL, rtol=F32_TOL)
    dense = dense_attention(q, k, v, bias=make_bias(kv_valid=valid))
    torch.testing.assert_close(got, dense, atol=F32_TOL, rtol=F32_TOL)


def _cuda_source():
    return (Path(tda.__file__).parents[1] / "csrc"
            / "decode_attention.cu").read_text()


def test_plan_constants_match_the_cuda_source():
    src = _cuda_source()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m[1])

    assert const("kRows") == tda.DEC_ROWS
    assert const("kKeys") == tda.DEC_KEYS
    assert const("kStages") == tda.DEC_STAGES
    assert const("kMaxSplits") == tda.DEC_MAX_SPLITS
    assert f"__launch_bounds__(kThreads, {tda.DEC_CTAS_PER_SM})" in src
    # an instance per head dim a configuration has, and no other
    assert {int(h) for h in re.findall(r"launch<(\d+)>\(", src)} \
        == set(tda.DEC_HEAD_DIMS)


# (B, T, Hq, Hkv, S, hd) -> (row_tiles, splits, per_split, ctas) on 132
# SMs: the batched serving step, bench.py's B = 1 request, Dream-7B's GQA
# (28 / 4) batched and at B = 1, a non-flash prefill, the smallest shape
PLANS = [((32, 32, 32, 32, 1184, 128), (1, 1, 19, 1024)),
         ((1, 32, 32, 32, 1088, 128), (1, 6, 3, 192)),
         ((32, 32, 28, 4, 1184, 128), (4, 1, 19, 512)),
         ((1, 32, 28, 4, 1184, 128), (4, 10, 2, 160)),
         ((1, 1056, 32, 32, 1088, 128), (17, 3, 6, 1632)),
         ((1, 1, 1, 1, 1, 16), (1, 1, 1, 1))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan_at_path_shapes(shape, want):
    p = tda.decode_plan(*shape, 132)
    assert tuple(p) == want
    B, T, Hq, Hkv, S, hd = shape
    tiles = -(-S // tda.DEC_KEYS)
    assert (p.splits - 1) * p.per_split < tiles <= p.splits * p.per_split
    assert (p.row_tiles - 1) * tda.DEC_ROWS < Hq // Hkv * T \
        <= p.row_tiles * tda.DEC_ROWS


@pytest.mark.parametrize("shape", [(1, 32, 8, 3, 100, 128),   # Hq % Hkv
                                   (1, 32, 8, 8, 100, 72),    # hd % 16
                                   (1, 32, 8, 8, 100, 64),    # no instance
                                   (1, 32, 8, 8, 100, 144),   # hd > 128
                                   (1, 32, 8, 8, 0, 128)])
def test_plan_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        tda.decode_plan(*shape, 132)


def test_cpu_call_is_the_plain_version_and_counts_no_launch():
    g = torch.Generator().manual_seed(2)
    q, k, v, valid = _inputs(g, 2, 8, 4, 2, 16, 40, 3, torch.bfloat16)
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, valid)
    assert torch.equal(got, tda.decode_attention_reference(q, k, v, valid))
    assert tda.decode_attention.launches == before


# ---------------------------------------------------------------------------
# the route LLaDA.forward gives each mode
# ---------------------------------------------------------------------------

def _tiny(device, dtype=torch.bfloat16, **cfg):
    m = LLaDA(tiny_llada_config(**cfg), "cpu", dtype)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in m.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.2)
    return m.to(device)


def _modes(m, device, dtype):
    """{name: call} for every attention mode of LLaDA.forward; each call
    runs the forward once on fresh buffers."""
    cfg = m.cfg
    B, P, G, D = 2, 12, 8, cfg.d_model
    g = torch.Generator().manual_seed(5)
    prefix = torch.randn(B, P, D, generator=g).to(device, dtype)
    x = torch.randn(B, G, D, generator=g).to(device, dtype)
    pv = torch.ones(B, P, dtype=torch.bool, device=device)
    pv[1, :3] = False
    kvv = torch.cat([pv, torch.ones(B, G, dtype=torch.bool, device=device)], 1)

    def filled():
        return td.prefill_cache(m, prefix, G, pv)

    def write_index():
        m(x, kv_cache=filled(), kv_valid=kvv, kv_write_index=P,
          use_cache=True)

    def write_index_no_mask():
        m(x, kv_cache=filled(), kv_write_index=P, use_cache=True)

    def causal():
        m(x, kv_cache=filled(), kv_valid=kvv, kv_write_index=P,
          use_cache=True, causal=True)

    def scatter():
        m(x, kv_cache=filled(), kv_valid=kvv,
          kv_scatter_idx=torch.arange(P, P + G, device=device),
          positions=torch.arange(P, P + G, device=device), use_cache=True)

    def concat():
        past = [(k[:, :P], v[:, :P]) for k, v in filled()]
        m(x, kv_cache=past, kv_valid=pv, use_cache=True)

    def no_cache():
        m(torch.cat([prefix, x], 1), self_valid=kvv)

    def plain_prefill():
        shape = (B, P + G, m.kv_heads, cfg.head_dim)
        cache = [(prefix.new_zeros(shape), prefix.new_zeros(shape))
                 for _ in m.blocks]
        m(prefix, kv_cache=cache, kv_write_index=0, kv_valid=kvv,
          self_valid=pv, use_cache=True)

    def flash_prefill():
        filled()

    def kv8():
        m(x, kv_cache=td.quantize_cache(filled()), kv_valid=kvv,
          kv_write_index=P, use_cache=True)

    return {"write_index": write_index,
            "write_index_no_mask": write_index_no_mask, "causal": causal,
            "scatter": scatter, "concat": concat, "no_cache": no_cache,
            "plain_prefill": plain_prefill, "flash_prefill": flash_prefill,
            "kv8": kv8}


# the attention each mode ran before the decode kernel: dense in all but
# the flash prefill (kernel #1) and the quantized cache (kernel #8)
DENSE_MODES = ("write_index", "write_index_no_mask", "causal", "scatter",
               "concat", "no_cache", "plain_prefill")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_mode_attends_as_before_on_the_cpu(monkeypatch, dtype):
    m = _tiny("cpu", dtype)
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return dense_attention(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("the decode route on the CPU")

    monkeypatch.setattr(tl, "dense_attention", counted)
    monkeypatch.setattr(tl, "decode_attention", refused)
    for name, run in _modes(m, "cpu", dtype).items():
        calls.clear()
        with torch.no_grad():
            run()
        # the flash prefill of the cache-filling modes attends through #1
        want = m.cfg.n_layers if name in DENSE_MODES else 0
        assert len(calls) == want, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# (B, T, Hq, Hkv, hd, S, pad): the batched serving step, bench.py's B = 1
# request (split keys), Dream-7B's 28 / 4 heads batched and at B = 1 (split
# keys), the tiny models' head dim, T of 1 and 64 and GQA, a prefill-sized
# T, one key, and (pad -1) a batch row that sees no key
CUDA_CASES = [(32, 32, 32, 32, 128, 1184, 0), (1, 32, 32, 32, 128, 1088, 0),
              (32, 32, 28, 4, 128, 1184, 0), (1, 32, 28, 4, 128, 1184, 0),
              (2, 32, 4, 2, 16, 77, 5), (1, 32, 8, 8, 16, 65, 1),
              (3, 1, 8, 2, 128, 200, 9), (2, 64, 8, 2, 128, 130, 17),
              (2, 16, 6, 2, 128, 1000, 31), (1, 1056, 32, 32, 128, 1088, 32),
              (1, 1, 1, 1, 128, 1, 0), (2, 32, 8, 2, 128, 333, -1)]


@pytest.mark.parametrize("case", CUDA_CASES)
def test_kernel_matches_plain_on_cuda(cuda, case):
    """The kernel, its key splits merged where the plan splits, against
    the plain version's unsplit softmax over the same bf16 inputs; twice,
    the second over new data in the same buffers."""
    B, T, Hq, Hkv, hd, S, pad = case
    g = torch.Generator().manual_seed(sum(case))
    q, k, v, valid = _inputs(g, B, T, Hq, Hkv, hd, S, max(pad, 0),
                             torch.bfloat16, cuda)
    # the batch rows' front padding, as generate_batch pads
    valid[:, :(S // 3)] &= torch.rand(B, S // 3, generator=g).to(cuda) > 0.5
    if pad < 0:
        valid[0] = False
    splits = tda.decode_plan(B, T, Hq, Hkv, S, hd,
                             tda._sms(cuda.index or 0)).splits
    for rep in range(2):
        if rep:
            for t in (q, k, v):
                t.copy_(torch.randn(t.shape, generator=g).to(cuda, t.dtype))
        before = tda.decode_attention.launches
        got = tda.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        assert tda.decode_attention.launches == before + 1
        ref = tda.decode_attention_reference(q, k, v, valid)
        err = (got.float() - ref.float()).abs().max().item()
        print(f"{case} splits {splits}: max error {err:.3e}")
        torch.testing.assert_close(got.float(), ref.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)


def test_wrapper_checks_its_inputs_on_cuda(cuda):
    g = torch.Generator().manual_seed(6)
    q, k, v, valid = _inputs(g, 1, 8, 4, 2, 128, 70, 0, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k.float(), v, valid)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k.transpose(1, 2).contiguous()
                             .transpose(1, 2), v, valid)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, v, valid.int())
    with pytest.raises(ValueError):
        tda.decode_attention(q.float(), k, v, valid)


def test_routes_on_cuda(cuda):
    """The write-index calls over a bf16 cache (the decode steps and a
    prefill without the flash kernel) launch the kernel once a layer; no
    other mode does, nor a head dim the kernel is not built for (64), and
    no mode adds short-attention launches beyond its flash prefill's
    (kernel #8 takes no f32 queries)."""
    models = (("bf16", torch.bfloat16, {}), ("f32", torch.float32, {}),
              ("hd64", torch.bfloat16, {"d_model": 128, "n_heads": 2,
                                        "n_kv_heads": 2}))
    cases = {f"{name} {n}": r for name, dtype, cfg in models
             for n, r in _modes(_tiny(cuda, dtype, **cfg), cuda,
                                dtype).items()}
    del cases["f32 kv8"]
    L = tiny_llada_config().n_layers
    routed = ("bf16 write_index", "bf16 write_index_no_mask",
              "bf16 plain_prefill")
    for name, run in cases.items():
        d0, s0 = tda.decode_attention.launches, short_attention.launches
        k0 = kv8_decode_attention.launches
        with torch.no_grad():
            run()
        torch.cuda.synchronize()
        assert tda.decode_attention.launches - d0 == \
            (L if name in routed else 0), name
        fills = name.split()[1] not in ("no_cache", "plain_prefill")
        # the flash prefill of the cache-filling modes attends through #1
        assert short_attention.launches - s0 == (L if fills else 0), name
        assert kv8_decode_attention.launches - k0 == \
            (L if name.endswith("kv8") else 0), name


SERVE_GAP_LIMIT = 3.3   # the serving check's limit on a committed token
# the largest |logit| gap between the kernel route and the dense route at
# one step.  Read on an NVIDIA H100 80GB HBM3: the kernel route 0.0883,
# planted faults 5.99 (a dropped 64-key tile) and 6.64 (the mask
# ignored); the limit lies between them, about 8x from each
LOGIT_GAP_LIMIT = 0.75
DROPPED_TILE = slice(128, 192)   # keys every batch row sees


def test_denoised_batch_matches_the_dense_route_on_cuda(cuda, monkeypatch):
    """One batch of 8 front-padded prefixes denoised in 16 steps at the
    LLaDA-8B head geometry (2 seeded layers): at each step, from the
    kernel route's state, the dense route's logits and commits.  The
    largest logit gap stays under LOGIT_GAP_LIMIT, which two planted
    faults at the same states (a key tile dropped, the mask ignored)
    exceed; every token the kernel route commits lies within the serving
    check's limit of the dense logits' best at its position."""
    cfg = tl.LLaDAConfig(n_layers=2, vocab_size=4096, embedding_size=4096,
                         mask_token_id=4000, eos_token_id=4001,
                         pad_token_id=4001)
    model = LLaDA(cfg, "meta", torch.bfloat16).to_empty(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if prm.dim() == 1:
                prm.fill_(1.0)
            else:
                prm.normal_(0.0, 0.02, generator=gen)
    B, P, G, steps = 8, 320, 32, 16
    prefix = torch.randn(B, P, cfg.d_model, device=cuda,
                         generator=gen).bfloat16()
    pv = torch.ones(B, P, dtype=torch.bool, device=cuda)
    for b in range(B):
        pv[b, :(37 * b) % 100] = False
    kvv = torch.cat([pv, torch.ones(B, G, dtype=torch.bool, device=cuda)], 1)
    with torch.no_grad():
        cache = td.prefill_cache(model, prefix, G, pv)
        x = torch.full((B, G), cfg.mask_token_id, device=cuda)
        k = torch.full((B,), G // steps, device=cuda)
        pos = torch.arange(P, P + G, device=cuda)

        def step(route=None):
            with monkeypatch.context() as mp:
                if route is not None:
                    mp.setattr(tl, "decode_attention", route)
                return model(model.embed_tokens(x), positions=pos,
                             kv_cache=cache, kv_valid=kvv, kv_write_index=P,
                             use_cache=True)[0].float()

        def dropped_tile(q, k_, v, valid):
            valid = valid.clone()
            valid[:, DROPPED_TILE] = False
            return tda.decode_attention(q, k_, v, valid)

        faults = {"dropped tile": dropped_tile,
                  "mask ignored": lambda q, k_, v, valid:
                  tda.decode_attention(q, k_, v)}
        worst = differ = 0
        logit_gap = 0.0
        fault_gap = {name: 0.0 for name in faults}
        for _ in range(steps):
            before = tda.decode_attention.launches
            logits = step()
            assert tda.decode_attention.launches == before + cfg.n_layers
            dense = step(lambda q, k_, v, valid: dense_attention(
                q, k_, v, bias=make_bias(kv_valid=valid)))
            logit_gap = max(logit_gap, (logits - dense).abs().max().item())
            for name, route in faults.items():
                gap = (step(route) - dense).abs().max().item()
                fault_gap[name] = max(fault_gap[name], gap)
            mask = x == cfg.mask_token_id
            nxt = sampling.denoise_commit(x, logits, mask, k, G)
            ref = sampling.denoise_commit(x, dense, mask, k, G)
            new = nxt != x
            best = dense.max(dim=-1).values
            chosen = dense.gather(-1, nxt[..., None])[..., 0]
            gap = torch.where(new, best - chosen, 0.0).max().item()
            worst = max(worst, gap)
            differ += int((nxt != ref).sum())
            x = nxt
    print(f"denoised batch: {differ} committed tokens differ from the dense "
          f"route's, worst commit gap {worst:.3f}, logit gap {logit_gap:.4f}"
          f", planted faults {fault_gap}")
    assert (x != cfg.mask_token_id).all()
    assert worst < SERVE_GAP_LIMIT
    assert logit_gap < LOGIT_GAP_LIMIT < min(fault_gap.values())
