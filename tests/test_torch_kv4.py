"""The int4 KV cache of the port (`--kv4`: lavida_mod_tpu_torch.ops.
kv8_attention with bits=4, kernel #8's int4 instance) against the JAX
package's lavida_mod_tpu/ops/kv8_attention.py, its Pallas kernel run in
interpret mode over a jnp.int4 cache on the CPU, as tests/test_kv8.py runs
it.

  - `quantize_kv(bits=4)`: codes and scales bit-exact to JAX's, op by op
    (the quotient by 7) and inside jax.jit (XLA's product by f32(1 / 7),
    which the decode runs: `reciprocal=True`); the packing round-trips and
    puts code 2i in the low nibble of byte i; `dequantize_kv` and
    `write_rows` (the decode's reciprocal form) equal JAX's.
  - The plain attention unpacks and runs its int8 arithmetic: within 6e-3
    of the interpret kernel over the same int4 codes, MHA and GQA, with
    masked rows.
  - Whole generations with kv8=4 (the B = 3 batch and the chunked B = 5
    path of tests/test_torch_batch.py's model) teacher-forced per step
    against JAX's `generate(..., kv8=4)` steps (torch_jax_strict), and
    `generate_fused(kv8=4)` on the tiny mixed layout.
  - `kv8_plan(bits=4)`'s stage bytes are the source's formula.
The CUDA instance is held to the plain version by the tests that need a
card (skipped without):
    python -m pytest --noconftest -k cuda tests/test_torch_kv4.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
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


def _codes(packed):
    """Port packed codes -> the jnp.int4 array JAX's cache holds."""
    return jnp.asarray(tk.unpack_kv4(packed).numpy(), jnp.int4)


def test_pack_round_trips_in_nibble_order():
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(-8, 8, (3, 5, 7, 32), np.int8))
    packed = tk.pack_kv4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, 7, 16)
    assert torch.equal(tk.unpack_kv4(packed), codes)
    c = codes.to(torch.int16) & 0xF
    assert torch.equal(packed.to(torch.int16), c[..., 0::2] | (c[..., 1::2] << 4))
    assert tk.is_kv4(packed) and not tk.is_kv4(codes)


@pytest.mark.parametrize("jit", [False, True])
def test_quantize_kv4_bit_exact(jit):
    """Eager JAX divides by 7; jitted JAX (its decode) multiplies by f32(1 /
    7).  The port's quotient form equals the first, its reciprocal form
    the second; a row of zeros takes the 1e-8 floor."""
    rng = np.random.default_rng(1)
    x = _bf16(rng.standard_normal((2, 300, 4, 128)) * 3.0)
    x[0, 3] = 0.0
    fn = (jax.jit(lambda a: KV8.quantize_kv(a, 4)) if jit
          else lambda a: KV8.quantize_kv(a, 4))
    jq, js = fn(_jnp(x))
    q, s = tk.quantize_kv(x, bits=4, reciprocal=jit)
    assert q.shape == (2, 4, 300, 64) and s.shape == (2, 4, 1, 300)
    np.testing.assert_array_equal(tk.unpack_kv4(q).numpy(),
                                  np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int(tk.unpack_kv4(q).abs().max()) == 7
    np.testing.assert_array_equal(
        tk.dequantize_kv(q, s).numpy(),
        np.asarray(KV8.dequantize_kv(jq, js)))
    other = tk.quantize_kv(x, bits=4, reciprocal=not jit)[1]
    assert not torch.equal(other, s), "the two scale forms must differ"


def test_write_rows_int4_bit_exact_and_in_place():
    """An int4 cache takes its width from its dtype; the rows are
    quantized as JAX's jitted decode quantizes them."""
    rng = np.random.default_rng(2)
    B, H, S, hd, T = 2, 3, 48, 64, 8
    k4 = tk.pack_kv4(torch.from_numpy(rng.integers(-7, 8, (B, H, S, hd),
                                                   np.int8)))
    v4 = tk.pack_kv4(torch.from_numpy(rng.integers(-7, 8, (B, H, S, hd),
                                                   np.int8)))
    ks = torch.from_numpy(rng.random((B, H, 1, S), np.float32))
    vs = torch.from_numpy(rng.random((B, H, 1, S), np.float32))
    k_new = _bf16(rng.standard_normal((B, T, H, hd)))
    v_new = _bf16(rng.standard_normal((B, T, H, hd)))
    want = jax.jit(KV8.write_rows, static_argnums=6)(
        _codes(k4), jnp.asarray(ks.numpy()), _codes(v4),
        jnp.asarray(vs.numpy()), _jnp(k_new), _jnp(v_new), 16)
    bufs = (k4, ks, v4, vs)
    got = tk.write_rows(*bufs, k_new, v_new, 16)
    for i, (g, w, b) in enumerate(zip(got, want, bufs)):
        assert g is b                                # written in place
        if i % 2 == 0:
            assert g.dtype == torch.uint8
            g = tk.unpack_kv4(g)
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(g.numpy().dtype))


def _attn_inputs(seed, B, T, H, Hkv, hd, S):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((B, T, H, hd)))
    k4, ks = tk.quantize_kv(_bf16(rng.standard_normal((B, S, Hkv, hd))), 4)
    v4, vs = tk.quantize_kv(_bf16(rng.standard_normal((B, S, Hkv, hd))), 4)
    return q, k4, ks, v4, vs


@pytest.mark.parametrize("B,T,H,Hkv,hd,S,pad", [
    (2, 32, 4, 4, 128, 160, 0),        # MHA (G = 1)
    (2, 32, 4, 4, 128, 160, 37),       # front-padded prefix
    (1, 16, 8, 2, 128, 96, 0),         # GQA, G = 4
    (2, 8, 8, 2, 64, 72, 11),          # GQA, padded, hd 64
    (2, 8, 4, 4, 16, 90, -1),          # hd 16, row 0's keys all masked
    (1, 8, 14, 2, 32, 200, 23),        # Dream's GQA, G = 7, hd 32
])
def test_plain_matches_interpret_kernel_over_int4(B, T, H, Hkv, hd, S, pad):
    q, k4, ks, v4, vs = _attn_inputs(hash((B, T, H, S, pad)) % 1000, B, T,
                                     H, Hkv, hd, S)
    valid = None
    if pad:
        valid = torch.ones(B, S, dtype=torch.bool)
        valid[0, :pad if pad > 0 else S] = False      # row 0 front-padded
    got = tk.kv8_decode_attention(q, k4, ks, v4, vs, valid)
    want = KV8.kv8_decode_attention(
        _jnp(q), _codes(k4), jnp.asarray(ks.numpy()), _codes(v4),
        jnp.asarray(vs.numpy()),
        kv_valid=None if valid is None else jnp.asarray(valid.numpy()))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL, rtol=TOL)
    # the plain version is the int8 arithmetic over the unpacked codes
    same = tk.kv8_decode_attention_reference(
        q, tk.unpack_kv4(k4), ks, tk.unpack_kv4(v4), vs, valid)
    assert torch.equal(got, same)


def test_plan_stage_bytes_follow_the_width():
    src = (Path(tk.__file__).parents[1] / "csrc"
           / "kv8_attention.cu").read_text()
    assert "return 2 * kKeys * (hd * bits / 8) + kScaleBytes;" in src
    assert "extern \"C\" int lavida_kv4_decode_attention(" in src
    for hd in (16, 32, 64, 128, 256):
        assert tk.kv8_stage_bytes(hd, 4) == 2 * 128 * hd // 2 + 2048
        assert tk.kv8_stage_bytes(hd, 8) == 2 * 128 * hd + 2048
    p8 = tk.kv8_plan(4, 32, 32, 32, 1184, 128, 132)
    p4 = tk.kv8_plan(4, 32, 32, 32, 1184, 128, 132, bits=4)
    assert p4._replace(smem=p8.smem) == p8
    assert p4.smem <= p8.smem
    with pytest.raises(ValueError):
        tk.kv8_plan(1, 32, 8, 8, 100, 128, 132, bits=2)
    # where the splits' merge area is larger than the int4 ring, it sets
    # the shared memory
    p = tk.kv8_plan(1, 32, 8, 8, 300, 256, 132, bits=4)
    assert p.smem == 1024 + max(p.stages * tk.kv8_stage_bytes(256, 4),
                                (p.splits - 1) * p.row_tiles
                                * (64 * 256 + 512))
    assert re.search(r"const int ring = stages \* stage_bytes\(hd, bits\);",
                     src)


def test_cpu_route_counts_no_launch():
    before = (tk.kv8_decode_attention.launches,
              tk.kv8_decode_attention.int4_launches)
    tk.kv8_decode_attention(*_attn_inputs(0, 1, 8, 2, 2, 64, 40))
    assert (tk.kv8_decode_attention.launches,
            tk.kv8_decode_attention.int4_launches) == before


# ---------------------------------------------------------------------------
# whole generations over the int4 cache, teacher-forced against JAX
# ---------------------------------------------------------------------------

KV4_CASES = [("b3_kv4", 3, 4, None), ("b5_chunked_kv4", 5, 4, 2)]


@pytest.fixture(scope="module")
def batch_setup(tmp_path_factory):
    from test_torch_batch import (CASES, GEN, JAX_MODEL, SIZES, _jax_model,
                                  _requests)
    from torch_jax_strict import JAX_STEPS, strict_jax

    from lavida_mod_tpu_torch.models.lavida import LaViDa

    del CASES
    jm, _ = _jax_model()
    tm = LaViDa.from_jax(jm.cfg, jax.tree.map(np.asarray, jm.params), "cpu")
    reqs = _requests(5)
    inputs = {}
    for i, (ids, views, _) in enumerate(reqs):
        inputs[f"ids{i}"], inputs[f"views{i}"] = ids, views[0]
    ref = strict_jax(JAX_MODEL + JAX_STEPS + f"""
from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.generation import diffusion
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.ops import kv8_attention as KV8
from lavida_mod_tpu.ops.short_attention import short_attention

jl.FORCE_FUSED_INTERPRET = True
KV8._INTERPRET[0] = True
jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
jm = jax_model()
lc = jm.cfg.llada
gen = GenerationConfig(**{GEN!r})
sizes = {SIZES!r}

def batch(n):
    pre = [jm.encode_prompt(IN[f"ids{{i}}"], [IN[f"views{{i}}"]],
                            [sizes[i]])[0] for i in range(n)]
    Pb = max(-(-p.shape[0] // 128) * 128 for p in pre)
    out = jnp.zeros((n, Pb, pre[0].shape[-1]), pre[0].dtype)
    valid = np.zeros((n, Pb), bool)
    for b, p in enumerate(pre):
        out = out.at[b, Pb - p.shape[0]:].set(p)
        valid[b, Pb - p.shape[0]:] = True
    return out, jnp.asarray(valid)

for name, n, kv8, chunk in {KV4_CASES!r}:
    prefix, valid = batch(n)
    if chunk:
        OUT[name + "/tokens"] = diffusion.generate_chunked_prefill(
            jm.params["llada"], lc, prefix, gen, chunk=chunk,
            prefix_valid=valid, use_flash_prefill=True, kv8=kv8)
    else:
        OUT[name + "/tokens"] = diffusion.generate(
            jm.params["llada"], lc, prefix, gen, prefix_valid=valid,
            kv8=kv8, use_flash_prefill=True)
    OUT[name + "/xs"], OUT[name + "/logits"], cache = jax_steps(
        jm.params["llada"], lc, prefix, gen, prefix_valid=valid, kv8=kv8,
        keep_cache=True)
    for i, a in enumerate(cache):
        OUT[name + f"/cache{{i}}"] = a
    # JAX against itself: each step again from the same buffer, the int4
    # cache quantized op by op (the quotient by 7) instead of as its jitted
    # decode does (the product by f32(1 / 7))
    OUT[name + "/eager_logits"] = jax_steps(
        jm.params["llada"], lc, prefix, gen, prefix_valid=valid, kv8=kv8,
        jit_kv4=False, replay=OUT[name + "/xs"])[1]
    OUT[name + "/prefix"] = np.asarray(prefix.astype(jnp.float32))
    OUT[name + "/valid"] = np.asarray(valid)
""", tmp_path_factory.mktemp("kv4"), inputs, timeout=1200)
    return tm, reqs, ref, GEN


@pytest.mark.parametrize("name,n,kv8,chunk", KV4_CASES)
def test_generate_batch_kv4_against_jax(batch_setup, name, n, kv8, chunk):
    """generate_batch with kv8=4 (diffusion.generate at B = 3, the chunked
    prefill at B = 5): every mask filled.  The port's decode-entry int4
    cache, prefilled from JAX's prefix, holds JAX's codes but for a few
    rounding-boundary flips of one step, and JAX's scales but for a few
    (under 5 %: a row's amax some bf16 roundings apart).  On the int4
    grid one code moves this model's logits by several percent (its cache quantized to int4 moves them by 139 % of
    max |logit|, int8 by 31 %), so each step is teacher-forced from JAX's
    own decode-entry cache.  JAX's two int4 quantizations (op by op, the
    quotient; jitted, the product), run from the same buffers, lie 40-84 %
    of max |logit| apart at every step; the port's logits lie within 10 %
    of the jitted one (0.2-6.2 % measured on the CPU), and its commits
    equal JAX's but for counted near-ties."""
    from torch_jax_strict import teacher_forced

    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.eval.adapter import generate_batch
    from lavida_mod_tpu_torch.generation import diffusion as td

    tm, reqs, ref, GEN = batch_setup
    gen = GenerationConfig(**GEN)
    got, _ = generate_batch(tm, reqs[:n], gen, kv8=kv8)
    want = ref[name + "/tokens"]
    mask = tm.cfg.llada.mask_token_id
    assert got.shape == want.shape == (n, 32) and (got != mask).all()
    prefix = torch.from_numpy(ref[name + "/prefix"]).bfloat16()
    valid = torch.from_numpy(ref[name + "/valid"])
    own = td.prefill_cache(tm.llada, prefix, 32, valid, kv8=kv8, chunk=chunk)
    cache, flips, total, scales_off, scales = _jax_cache(
        own, ref, name, tm.cfg.llada.head_dim)
    assert flips < 0.01 * total, (flips, total)
    assert scales_off < 0.01 * scales, (scales_off, scales)
    gaps = _gaps(ref, name)
    print(f"{name}: JAX's own gap per step, eager against jitted int4 "
          f"quantization: {[round(g, 4) for g in gaps]}")
    # the band: 10 % of max |logit|, under half of JAX's own gap at every
    # step (40-84 % on this model, measured on the CPU)
    band = 0.1
    assert min(gaps) > 2 * band, gaps
    ties = teacher_forced(tm, prefix, gen, ref[name + "/xs"],
                          ref[name + "/logits"], prefix_valid=valid,
                          kv8=kv8, chunk=chunk, cache=cache, band=band)
    agree = float((got == want).mean())
    print(f"{name}: tokens agree with JAX {agree:.3f}; decode-entry codes "
          f"one step off JAX's: {flips} of {total}, scales over a bf16 "
          f"rounding off: {scales_off} of {scales}; near-tie exceptions of "
          f"the teacher-forced steps (step, row, gap, bound): {ties}")


def _jax_cache(own, ref, key, hd):
    """JAX's decode-entry int4 cache (`ref[key + "/cache{i}"]`) as the port
    holds it, beside the port's own: (cache, codes one step off, codes,
    scales over a bf16 rounding off, scales); raises where a code is more
    than one step off or a scale 5 % or more."""
    out, flips, total, scales_off, scales = [], 0, 0, 0, 0
    for li, layer in enumerate(own):
        arrays = [ref[f"{key}/cache{4 * li + i}"] for i in range(4)]
        for i, (mine, theirs) in enumerate(zip(layer, arrays)):
            if i % 2 == 0:
                assert mine.dtype == torch.uint8
                assert mine.shape[-1] == hd // 2
                mine = tk.unpack_kv4(mine).numpy().astype(np.int16)
                assert np.abs(mine - theirs).max() <= 1
                flips += int((mine != theirs).sum())
                total += mine.size
                out.append(tk.pack_kv4(torch.from_numpy(theirs)))
            else:
                rel = np.abs(mine.numpy() - theirs) / theirs
                assert rel.max() < 0.05
                scales_off += int((rel > 2 ** -8).sum())
                scales += rel.size
                out.append(torch.from_numpy(theirs))
    cache = [tuple(out[4 * li:4 * li + 4]) for li in range(len(own))]
    return cache, flips, total, scales_off, scales


def _gaps(ref, key):
    """JAX's own per-step gap between its op-by-op and jitted int4
    quantization, as a share of max |logit|."""
    return [float(np.abs(e - m).max() / np.abs(m).max())
            for e, m in zip(ref[key + "/eager_logits"], ref[key + "/logits"])]


def test_generate_fused_kv4_mixed_layout_against_jax(tmp_path):
    """generate_fused(kv8=4) in the mixed fused layout (tests/
    test_torch_mixed.py's model, LLaDA weights x4): every mask filled; the
    decode-entry int4 cache of JAX's prefix holds JAX's codes but for a
    few one-step flips; each step, teacher-forced from JAX's own cache and
    buffers, within JAX's own gap at that step between its op-by-op and
    its jitted int4 quantization (the fused kernels' plain versions differ
    from JAX's interpret kernels by up to 5.3 % of max |logit| per step
    over a bf16 cache, module note of tests/test_torch_mixed.py, and the
    int4 grid amplifies it), commits equal but for counted near-ties."""
    from test_torch_mixed import GEN, JAX_MODEL, REQUESTS, SCALE
    from test_torch_mixed import _jax_model, _port, _request
    from torch_jax_strict import JAX_STEPS, strict_jax, teacher_forced

    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation import diffusion as td

    size, seed = REQUESTS[0]
    ids, views = _request(size, seed)
    ref = strict_jax(JAX_MODEL + JAX_STEPS + f"""
from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import multimodal as jmm
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.ops import kv8_attention as KV8
from lavida_mod_tpu.ops.short_attention import short_attention

jl.FORCE_FUSED_INTERPRET = True
KV8._INTERPRET[0] = True
jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
jm = jax_model(scale={SCALE!r})
lc = jm.cfg.llada
gen = GenerationConfig(**{GEN!r})
ids, views = IN["ids"], IN["views"]
OUT["m/tokens"] = jm.generate_fused(ids, [views], [{size!r}], gen,
                                    use_flash_prefill=True, kv8=4)
idx, text_ids, _, _ = jmm.build_gather_plan(
    jm.cfg, [ids], [[views.shape[0]]], [[{size!r}]])
prefix = jmm.multimodal_embeds(jm.params, jm.cfg, jnp.asarray(views),
                               jnp.asarray(text_ids), jnp.asarray(idx))
kw = dict(pre_p=jm.prefill_params, act_int8=True, kv8=4)
OUT["m/xs"], OUT["m/logits"], cache = jax_steps(
    jm.params["llada"], lc, prefix, gen, keep_cache=True, **kw)
for i, a in enumerate(cache):
    OUT[f"m/cache{{i}}"] = a
OUT["m/eager_logits"] = jax_steps(jm.params["llada"], lc, prefix, gen,
                                  jit_kv4=False, replay=OUT["m/xs"], **kw)[1]
OUT["m/prefix"] = np.asarray(prefix.astype(jnp.float32))
""", tmp_path, {"ids": ids, "views": views}, timeout=1200)
    tm = _port(_jax_model(scale=SCALE))
    assert tm.mixed and tm.llada.blocks[0].fused_plan(32, False)
    gen = GenerationConfig(**GEN)
    got = tm.generate_fused(ids, [views], [size], gen, kv8=4)
    mask = tm.cfg.llada.mask_token_id
    assert got.shape == (32,) and (got != mask).all()
    assert len(set(ref["m/tokens"].tolist())) >= 4, "degenerate"
    prefix = torch.from_numpy(ref["m/prefix"]).bfloat16()
    own = td.prefill_cache(tm.llada, prefix, 32, None, True, 4)
    cache, flips, total, soff, scales = _jax_cache(
        own, ref, "m", tm.cfg.llada.head_dim)
    assert flips < 0.01 * total and soff < 0.01 * scales
    # the band of each step: JAX's own gap there (the port's step logits no
    # further from JAX's jitted decode than JAX's op-by-op replay is:
    # 1-11 % against 9-46 %, measured on the CPU)
    gaps = _gaps(ref, "m")
    ties = teacher_forced(tm, prefix, gen, ref["m/xs"], ref["m/logits"],
                          kv8=4, cache=cache, band=gaps)
    print(f"mixed kv4: tokens agree with JAX "
          f"{float((got == ref['m/tokens']).mean()):.3f}; codes one step "
          f"off {flips} of {total}, scales off {soff} of {scales}; JAX's "
          f"own gap per step {[round(g, 4) for g in gaps]}; near-tie "
          f"exceptions {ties}")


@pytest.mark.parametrize("extra", [[], ["--int4", "--batch", "3"]])
def test_predict_kv4_runs(extra, capsys):
    """`predict --kv4` (the JAX predict.py's flag) decodes over the int4
    cache, one request or a batch; it is exclusive with --kv8."""
    from lavida_mod_tpu_torch.predict import main

    main(["--tiny", "--device", "cpu", "--kv4", "--max-new-tokens", "8",
          "--step-per-block", "4", *extra])
    out = capsys.readouterr().out
    assert ", kv4" in out and "[predict] output ids" in out
    with pytest.raises(SystemExit):
        main(["--tiny", "--device", "cpu", "--kv4", "--kv8"])


# ---------------------------------------------------------------------------
# the CUDA int4 instance against the plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _cuda_inputs(g, device, B, T, H, Hkv, hd, S):
    q = torch.randn(B, T, H, hd, generator=g, device=device).bfloat16()
    k4, ks = tk.quantize_kv(torch.randn(B, S, Hkv, hd, generator=g,
                                        device=device).bfloat16(), 4)
    v4, vs = tk.quantize_kv(torch.randn(B, S, Hkv, hd, generator=g,
                                        device=device).bfloat16(), 4)
    return q, k4, ks, v4, vs


# (B, T, H, Hkv, hd, S, pad): row 0 front-padded by `pad` keys (-1: every
# key of row 0 masked), row b > 0 by (37 b) % (S // 4)
CUDA_CASES = [
    (4, 32, 32, 32, 128, 1184, 32),    # the B = 4 batch (one chunk)
    (8, 32, 32, 32, 128, 1184, 0),     # the B = 8 batch: two waves
    (1, 32, 32, 32, 128, 1088, 0),     # one request
    (4, 32, 28, 4, 128, 1184, 0),      # Dream-7B's GQA, G = 7
    (1, 32, 28, 4, 128, 1184, 400),    # a front pad longer than a chunk
    (2, 32, 16, 1, 128, 300, 0),       # G = 16: four row blocks, chunks
    (2, 32, 4, 4, 64, 6401, 0),        # many chunks, hd 64
    (1, 32, 8, 8, 128, 16384, 700),    # a long cache
    (2, 32, 32, 32, 128, 1184, -1),    # a batch row with every key masked
    (2, 32, 8, 8, 256, 500, 9),        # hd 256
    (2, 16, 8, 4, 32, 200, 3),         # hd 32 (16-byte rows, no swizzle)
    (1, 8, 4, 2, 16, 130, 0),          # hd 16: 8-byte rows by cp.async
    (3, 32, 4, 4, 16, 77, 5),          # hd 16, ragged S
    (1, 13, 8, 2, 64, 77, 5),          # ragged T and S, G = 4
]


def _valid(B, S, pad, device):
    valid = torch.ones(B, S, dtype=torch.bool, device=device)
    for b in range(B):
        valid[b, :(pad if pad >= 0 else S) if b == 0
              else (37 * b) % max(1, S // 4)] = False
    return valid


@pytest.mark.parametrize("B,T,H,Hkv,hd,S,pad", CUDA_CASES)
def test_kv4_kernel_matches_plain_on_cuda(cuda, B, T, H, Hkv, hd, S, pad):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k4, ks, v4, vs = _cuda_inputs(g, cuda, B, T, H, Hkv, hd, S)
    valid = _valid(B, S, pad, cuda)
    before = (tk.kv8_decode_attention.launches,
              tk.kv8_decode_attention.int4_launches)
    out = tk.kv8_decode_attention(q, k4, ks, v4, vs, valid)
    torch.cuda.synchronize()
    assert (tk.kv8_decode_attention.launches,
            tk.kv8_decode_attention.int4_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = tk.kv8_decode_attention_reference(q, k4, ks, v4, vs, valid)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    if pad == 0:
        torch.testing.assert_close(
            tk.kv8_decode_attention(q, k4, ks, v4, vs).float(),
            tk.kv8_decode_attention_reference(q, k4, ks, v4, vs).float(),
            atol=TOL, rtol=TOL)
    assert torch.equal(tk.kv8_decode_attention(q, k4, ks, v4, vs, valid), out)


def test_kv4_chained_calls_over_a_cache_written_in_place_on_cuda(cuda):
    """20 calls without a sync, each after write_rows has put new rows into
    the same int4 buffers, each held to the plain version on the cache as
    it was."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, T, H, Hkv, hd, S = 4, 32, 32, 32, 128, 1184
    q, k4, ks, v4, vs = _cuda_inputs(g, cuda, B, T, H, Hkv, hd, S)
    valid = _valid(B, S, 32, cuda)
    outs, refs = [], []
    for i in range(20):
        q = torch.randn(B, T, H, hd, generator=g, device=cuda).bfloat16()
        new = [torch.randn(B, T, Hkv, hd, generator=g,
                           device=cuda).bfloat16() for _ in range(2)]
        tk.write_rows(k4, ks, v4, vs, *new, (53 * i) % (S - T))
        outs.append(tk.kv8_decode_attention(q, k4, ks, v4, vs, valid))
        refs.append(tk.kv8_decode_attention_reference(q, k4, ks, v4, vs,
                                                      valid))
    torch.cuda.synchronize()
    assert k4.dtype == torch.uint8
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL,
                                   rtol=TOL)


def test_kv4_wrapper_checks_its_inputs_on_cuda(cuda):
    """What the int4 instance does not take raises; nothing falls back to
    the plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k4, ks, v4, vs = _cuda_inputs(g, cuda, 1, 8, 2, 2, 64, 300)
    with pytest.raises(ValueError, match="v8"):
        tk.kv8_decode_attention(q, k4, ks, tk.unpack_kv4(v4), vs)
    with pytest.raises(ValueError, match="k8"):
        tk.kv8_decode_attention(q, k4[..., :16].contiguous(), ks, v4, vs)
    with pytest.raises(ValueError, match="kv_valid"):
        tk.kv8_decode_attention(q, k4, ks, v4, vs,
                                torch.ones(1, 300, dtype=torch.int32,
                                           device=cuda))
    with pytest.raises(ValueError):
        tk.kv8_decode_attention(q.float(), k4, ks, v4, vs)
    before = tk.kv8_decode_attention.launches
    tk.kv8_decode_attention(q, k4, ks, v4, vs)
    assert tk.kv8_decode_attention.launches == before + 1


def test_kv4_decode_without_kv_valid_on_cuda(cuda):
    """A decode step of B > 1 rows over the int4 cache with no kv_valid:
    the model hands the kernel its filled-rows mask as contiguous bytes
    (an expanded view was refused), and the logits are the CPU's within
    5 % of max |logit|."""
    import copy

    from lavida_mod_tpu_torch.generation import diffusion as td
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.predict import tiny_config

    cfg = tiny_config()
    cpu = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    prefix = torch.randn(3, 20, cfg.llada.d_model,
                         generator=torch.Generator().manual_seed(5)) \
        .bfloat16()
    x = torch.full((3, 8), cfg.llada.mask_token_id)
    logits = []
    with torch.no_grad():
        cache = td.prefill_cache(cpu.llada, prefix, 8, kv8=4)
        for m in (cpu, gpu):
            c = [tuple(t.to(m.device).clone() for t in layer)
                 for layer in cache]
            before = tk.kv8_decode_attention.int4_launches
            out, _ = m.llada(m.llada.embed_tokens(x.to(m.device)),
                             positions=torch.arange(20, 28, device=m.device),
                             kv_cache=c, kv_write_index=20, use_cache=True)
            logits.append(out.float().cpu())
    assert tk.kv8_decode_attention.int4_launches == \
        before + cfg.llada.n_layers
    rel = ((logits[1] - logits[0]).abs().max()
           / logits[0].abs().max()).item()
    assert rel < 5e-2, rel

