"""The mixed serving layout as a whole (int8 prefill tree + fused int4
decode tree, bench.py's default) against the JAX package on the CPU.

The tiny config has every linear width a multiple of 512, so JAX's fused
decode plan and fused head engage (`_w4_fused_plan`, `_w4_head_fusable`)
once FORCE_FUSED_INTERPRET runs the Pallas kernels in interpret mode; the
port engages the same plan by geometry and runs the ops' plain versions.

  - The port's own `to_serving_layout("mixed")` on bf16 weights gives the
    state dict that `from_jax` makes of the JAX model after its
    `to_serving_layout("mixed", fuse=True)`: the quantizers and the
    converter agree bit for bit.
  - In this process (XLA's default excess precision), on the weights as
    initialised (std 0.02, as tests/test_w4_fused.py's model tests): the
    decode forward (three fused kernels per block, fused head) within 5 %
    of max |logit| (that file's model-level band), the int8 prefill within
    3 %.
  - With excess precision off (tests/torch_jax_strict.py), the JAX vision
    tower's attention run through its Pallas kernel as on the TPU (off
    the TPU it takes dense XLA attention, which normalizes before the PV
    product): the int8 prefill's hidden states are bit-exact; the decode
    logits and the first denoise step's logits of a whole request are
    within the 5 % band.  They are not bit-exact: the FFN kernel's SwiGLU
    takes exp in f32, where XLA's exp and PyTorch's differ in the last bit
    for some inputs, and a bf16 intermediate rounding the other way moves
    an activation code by one.  The projector's erf GELU does the same
    (XLA's erfc against PyTorch's): one prefix element of the second
    request lands one bf16 rounding away, and the int8 prefill of the x4
    model amplifies it.  Such a flip reorders near-tied low-confidence
    commits, after which a free-running loop follows another trajectory
    for good; how soon depends on the machine's libm (the same request
    agreed 97 % with JAX on one machine and 47 % on another; JAX's own
    one-executable generate_fused and its op-by-op replay differ there
    too).  So, with the LLaDA weights x4 so the tiny model's tokens vary,
    the test teacher-forces: the JAX child records its prefix, the token
    buffer before every denoise step and that step's logits; the port
    runs one step from each recorded buffer; every step's logits are
    within the 5 % band and every step commits JAX's positions and
    tokens, except at near-ties, which are counted and printed
    (torch_jax_strict.teacher_forced).  The free-running agreement is
    printed, not held.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (GenerationConfig, LaViDaConfig,
                                   VisionConfig, tiny_llada_config,
                                   tiny_siglip_config)
from lavida_mod_tpu.data.anyres import anyres_grid_shape
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.config import as_port_config
from lavida_mod_tpu_torch.convert import (prefill_state_from_jax,
                                          state_dict_from_jax)
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.ops import quant as tq
from torch_jax_strict import JAX_STEPS, REPO, strict_jax, teacher_forced

torch.set_num_threads(2)

CFG = LaViDaConfig(
    llada=tiny_llada_config(d_model=512, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=1024),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
GEN = dict(max_new_tokens=32, block_length=32, step_per_block=16,
           prefix_lm=True, remasking="low_confidence")
REQUESTS = [((100, 60), 5), ((120, 40), 3)]

# the JAX model of every test: bf16, the LLaDA weights scaled from the init
# (x4 where tokens must vary, tests/test_torch_generate.py), in the mixed
# layout -- as code, so the strict child process builds the same model
JAX_MODEL = """
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa

CFG = LaViDaConfig(
    llada=tiny_llada_config(d_model=512, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=1024),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))

def jax_model(mixed=True, scale=1.0):
    jm = JLaViDa.random_init(CFG, 0, jnp.bfloat16)
    jm.params["llada"] = jax.tree.map(
        lambda a: a * scale if a.ndim >= 2 else a, jm.params["llada"])
    if mixed:
        jm.to_serving_layout("mixed", fuse=True)
    return jm
"""


SCALE = 4.0


def _jax_model(mixed=True, scale=1.0):
    ns = {}
    exec(JAX_MODEL, ns)
    return ns["jax_model"](mixed, scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jm):
    return LaViDa.from_jax(jm.cfg, _np(jm.params), "cpu",
                           prefill_params=_np(jm.prefill_params))


def _request(size, seed):
    nw, nh = anyres_grid_shape(size, CFG.vision.grid_pinpoints, 56)
    rng = np.random.default_rng(seed)
    views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(np.float32)
    text = rng.integers(3, 400, size=6)
    return np.concatenate([text[:2], [-200], text[2:]]), views


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    return jm, _port(jm)


@pytest.fixture(scope="module")
def scaled():
    jm = _jax_model(scale=SCALE)
    return jm, _port(jm)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def test_port_layout_equals_converted_jax_layout(models):
    """Quantizing on the port's side (as chip_smoke.py does on the card)
    and converting the JAX mixed layout give the same tensors."""
    jm, tm = models
    bf = LaViDa.from_jax(CFG, _np(_jax_model(mixed=False).params), "cpu")
    bf.to_serving_layout("mixed", fuse=True)
    assert bf.cfg == as_port_config(jm.cfg) and bf.mixed and tm.mixed
    a, b = tm.state_dict(), bf.state_dict()
    assert a.keys() == b.keys()
    assert any(k.endswith(".prefill.att_proj.weight_q") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the two trees share the embedding and the norms
    blk = bf.llada.blocks[0]
    assert isinstance(blk.att_proj, tq.Int4Linear)
    assert isinstance(blk.prefill["att_proj"], tq.Int8Linear)
    assert not any(isinstance(m, torch.nn.Linear)
                   for m in bf.llada.modules())


def test_fused_plan_gates(models):
    _, tm = models
    blk, llada = tm.llada.blocks[0], tm.llada
    assert blk.fused_plan(32, act_int8=False)
    assert not blk.fused_plan(32, act_int8=True)
    assert not blk.fused_plan(40, act_int8=False)     # > 32 rows
    assert not blk.fused_plan(12, act_int8=False)     # not a multiple of 8
    assert llada.head_fusable(32) and not llada.head_fusable(136)
    # a 256-wide model pads att_proj's 768 columns to 1024: no fused plan,
    # as in JAX (the __trim_N__ key)
    small = LaViDa.random_init(CFG.replace(llada=tiny_llada_config(
        d_model=256, n_heads=2, n_kv_heads=2, mlp_hidden_size=512)), 0,
        torch.bfloat16, "cpu").to_serving_layout("mixed")
    assert small.llada.blocks[0].att_proj.padded
    assert not small.llada.blocks[0].fused_plan(32, act_int8=False)


def test_decode_forward_within_band_of_jax(models, monkeypatch):
    jm, tm = models
    monkeypatch.setattr(jl, "FORCE_FUSED_INTERPRET", True)
    x = np.full((1, 32), CFG.llada.mask_token_id, np.int32)
    x[0, ::3] = np.arange(11) + 5
    lp = jm.params["llada"]
    assert jl._w4_fused_plan(jm.cfg.llada, lp["blocks"][0], 32, False)
    want, _ = jl.forward(lp, jm.cfg.llada, jl.embed_tokens(lp, x))
    with torch.no_grad():
        got, _ = tm.llada(tm.llada.embed_tokens(torch.from_numpy(x).long()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got.numpy(), want) < 0.05
    # the fused head's logits are bf16 values cast to f32 (llada.py:
    # 684-699); the bf16 layout's head keeps f32 logits
    assert torch.equal(got, got.bfloat16().float())
    bf = LaViDa.from_jax(CFG, _np(_jax_model(mixed=False).params), "cpu")
    with torch.no_grad():
        lg, _ = bf.llada(bf.llada.embed_tokens(torch.from_numpy(x).long()))
    assert not torch.equal(lg, lg.bfloat16().float())



def test_last_logits_only_fuses_the_head_on_b_rows(models, monkeypatch):
    """With last_logits_only the fused int4 head is chosen on the B rows
    left after the cut, as llada.py:679-684 chooses it: 8 sequences of 20
    rows (160 rows, past the head's 128-row gate) fuse it on 8 rows."""
    from lavida_mod_tpu_torch.models import llada as tl

    jm, tm = models
    monkeypatch.setattr(jl, "FORCE_FUSED_INTERPRET", True)
    calls, fused = [], tl.w4_qkv_norm
    monkeypatch.setattr(tl, "w4_qkv_norm", lambda x, *a, **k: (
        calls.append(tuple(x.shape)), fused(x, *a, **k))[1])
    x = np.random.default_rng(3).integers(3, 400, (8, 20)).astype(np.int32)
    lp = jm.params["llada"]
    assert jl._w4_head_fusable(jm.cfg.llada, lp, lp["ff_out"], 8)
    assert not tm.llada.head_fusable(160) and tm.llada.head_fusable(8)
    want, _ = jl.forward(lp, jm.cfg.llada, jl.embed_tokens(lp, x),
                         last_logits_only=True)
    with torch.no_grad():
        got, _ = tm.llada(tm.llada.embed_tokens(torch.from_numpy(x).long()),
                          last_logits_only=True)
    assert got.shape == want.shape and got.shape[:2] == (8, 1)
    assert calls == [(8, 512)]
    assert torch.equal(got, got.bfloat16().float())
    assert _rel_err(got.numpy(), want) < 0.05

def test_int8_prefill_within_band_of_jax(models):
    jm, tm = models
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((1, 40, 512)).astype(np.float32)
    e = torch.from_numpy(emb).bfloat16()
    want, _ = jl.forward(jm.prefill_params, jm.cfg.llada,
                         jnp.asarray(e.float().numpy(), jnp.bfloat16),
                         return_logits=False, act_int8=True, use_flash=True)
    with torch.no_grad():
        got, _ = tm.llada(e, return_logits=False, act_int8=True,
                          use_flash=True)
    assert _rel_err(got.float().numpy(), want.astype(jnp.float32)) < 0.03


def _prefix(tm, ids, views, size):
    """The port's one-gather prefix embeddings [1, P, D] of a request."""
    from lavida_mod_tpu_torch.models import multimodal

    idx, text_ids, _, _ = multimodal.build_gather_plan(
        tm.cfg, [ids], [[views.shape[0]]], [[size]])
    with torch.no_grad():
        return multimodal.multimodal_embeds(tm, torch.from_numpy(views),
                                            text_ids, idx)


def _first_step_logits(tm, ids, views, size):
    """The port's logits of the first denoise step of one request."""
    from lavida_mod_tpu_torch.models import multimodal

    idx, text_ids, _, _ = multimodal.build_gather_plan(
        tm.cfg, [ids], [[views.shape[0]]], [[size]])
    lc, G = tm.cfg.llada, GEN["max_new_tokens"]
    with torch.no_grad():
        prefix = multimodal.multimodal_embeds(
            tm, torch.from_numpy(views), text_ids, idx)
        P = prefix.shape[1]
        shape = (1, P + G, lc.effective_n_kv_heads, lc.head_dim)
        cache = [(prefix.new_zeros(shape), prefix.new_zeros(shape))
                 for _ in tm.llada.blocks]
        tm.llada(prefix, kv_cache=cache, kv_write_index=0, use_cache=True,
                 return_logits=False, use_flash=True, act_int8=True)
        x = torch.full((1, G), lc.mask_token_id, dtype=torch.long)
        logits, _ = tm.llada(tm.llada.embed_tokens(x),
                             positions=torch.arange(P, P + G),
                             kv_cache=cache, kv_write_index=P,
                             use_cache=True)
    return logits.numpy()


def test_generate_without_excess_precision(models, scaled, tmp_path):
    _, tm = models
    _, tm4 = scaled
    inputs = {}
    for i, (size, seed) in enumerate(REQUESTS):
        inputs[f"ids{i}"], inputs[f"views{i}"] = _request(size, seed)
    mask = CFG.llada.mask_token_id
    x = np.full((1, 32), mask, np.int32)
    x[0, ::3] = np.arange(11) + 5
    inputs["x"] = x
    inputs["emb"] = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 40, 512)).astype(np.float32)).bfloat16().float().numpy()
    ref = strict_jax(JAX_MODEL + JAX_STEPS + f"""
from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import multimodal as jmm
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.ops.short_attention import short_attention

jl.FORCE_FUSED_INTERPRET = True
# the vision attention as the TPU runs it: the Pallas kernel
jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
jm, jm4 = jax_model(), jax_model(scale={SCALE!r})
lc = jm.cfg.llada
gen = GenerationConfig(**{GEN!r})
G = gen.max_new_tokens
for i, size in enumerate({[s for s, _ in REQUESTS]!r}):
    ids, views = IN[f"ids{{i}}"], IN[f"views{{i}}"]
    OUT[f"tokens{{i}}"] = jm4.generate_fused(ids, [views], [size], gen,
                                             use_flash_prefill=True)
    idx, text_ids, _, _ = jmm.build_gather_plan(
        jm.cfg, [ids], [[views.shape[0]]], [[size]])
    for name, m in (("", jm), ("4", jm4)):
        prefix = jmm.multimodal_embeds(
            m.params, m.cfg, jnp.asarray(views), jnp.asarray(text_ids),
            jnp.asarray(idx))
        xs, lg = jax_steps(m.params["llada"], lc, prefix, gen,
                           pre_p=m.prefill_params, act_int8=True)
        if name:
            OUT[f"xs{{i}}"], OUT[f"steps{{i}}"] = xs, lg
            OUT[f"prefix{{i}}"] = np.asarray(prefix.astype(jnp.float32))
        else:
            OUT[f"step{{i}}"] = lg[0]
lp = jm.params["llada"]
OUT["logits"] = np.asarray(jl.forward(
    lp, lc, jl.embed_tokens(lp, IN["x"]))[0])
OUT["prefill"] = np.asarray(jl.forward(
    jm.prefill_params, lc, jnp.asarray(IN["emb"], jnp.bfloat16),
    return_logits=False, act_int8=True, use_flash=True)[0].astype(
        jnp.float32))
""", tmp_path, inputs)
    with torch.no_grad():
        hidden, _ = tm.llada(torch.from_numpy(inputs["emb"]).bfloat16(),
                             return_logits=False, act_int8=True,
                             use_flash=True)
        logits, _ = tm.llada(tm.llada.embed_tokens(torch.from_numpy(x)
                                                   .long()))
    np.testing.assert_array_equal(hidden.float().numpy(), ref["prefill"])
    assert _rel_err(logits.numpy(), ref["logits"]) < 0.05
    gen = GenerationConfig(**GEN)
    report = []
    for i, (size, seed) in enumerate(REQUESTS):
        ids, views = inputs[f"ids{i}"], inputs[f"views{i}"]
        step = _first_step_logits(tm, ids, views, size)
        assert _rel_err(step, ref[f"step{i}"]) < 0.05
        got = tm4.generate_fused(ids, [views], [size], gen)
        assert got.shape == (32,) and (got != mask).all()
        assert len(set(ref[f"tokens{i}"].tolist())) >= 4, "degenerate"
        # the port's prefix is JAX's up to a few elements a rounding or
        # two apart (the projector's erf GELU, module note)
        want = torch.from_numpy(ref[f"prefix{i}"])
        prefix = _prefix(tm4, ids, views, size).float()
        off = prefix != want
        assert off.float().mean() < 1e-3, off.sum()
        assert (prefix - want).abs().max() <= 2 ** -7 * want.abs().max()
        # the free-running tokens need not agree (module note); each step
        # from JAX's own prefix and token buffer must
        ties = teacher_forced(tm4, want.bfloat16(), gen, ref[f"xs{i}"],
                              ref[f"steps{i}"])
        report.append(dict(prefix_off=int((prefix != want).sum()),
                           agreement=float((got == ref[f"tokens{i}"]).mean()),
                           near_ties=ties))
    print(f"per request: prefix elements off JAX's, free-running token "
          f"agreement, teacher-forced near-tie exceptions (step, row, gap, "
          f"bound): {report}")


@pytest.mark.parametrize("quant", ["int4", "int8"])
def test_single_tree_layouts_on_cpu(quant):
    """`to_serving_layout("int4" / "int8")` (one tree, prefill and decode;
    kernel #4 is not ported, so on the card they raise) against the JAX
    layouts on the CPU: the int4 tree's unfused math and the int8
    weight-only linears, decode logits within 5 %."""
    jm = _jax_model(mixed=False)
    tm = LaViDa.from_jax(CFG, _np(jm.params), "cpu")
    jm.to_serving_layout(quant, fuse=True)
    tm.to_serving_layout(quant, fuse=True)
    assert tm.cfg == as_port_config(jm.cfg) and not tm.mixed
    sd = LaViDa.from_jax(jm.cfg, _np(jm.params), "cpu").state_dict()
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in sd.items())
    x = np.full((1, 32), CFG.llada.mask_token_id, np.int32)
    x[0, ::3] = np.arange(11) + 5
    lp = jm.params["llada"]
    want, _ = jl.forward(lp, jm.cfg.llada, jl.embed_tokens(lp, x))
    with torch.no_grad():
        got, _ = tm.llada(tm.llada.embed_tokens(torch.from_numpy(x).long()))
    assert _rel_err(got.numpy(), want) < 0.05


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

def test_convert_maps_quantized_leaves_exactly(models):
    jm, _ = models
    sd = state_dict_from_jax(_np(jm.params))
    b0 = jm.params["llada"]["blocks"][0]
    # int4: re-packed into the fragment layout, the codes unchanged
    np.testing.assert_array_equal(
        tq.unpack_w4(sd["llada.blocks.0.att_proj.packed"]).numpy(),
        tq.unpack_w4_jax(np.asarray(b0["att_proj"]["kernel_p4"])))
    np.testing.assert_array_equal(sd["llada.blocks.0.att_proj.scales"],
                                  np.asarray(b0["att_proj"]["scales4"]))
    pre = prefill_state_from_jax(_np(jm.prefill_params),
                                 _np(jm.params["llada"]))
    p0 = jm.prefill_params["blocks"][0]["ff_out"]
    # int8: [K, N] codes transposed to [N, K]
    np.testing.assert_array_equal(
        pre["llada.blocks.0.prefill.ff_out.weight_q"].numpy(),
        np.asarray(p0["kernel_q"]).T)
    np.testing.assert_array_equal(pre["llada.blocks.0.prefill.ff_out.scale"],
                                  np.asarray(p0["scale"]))
    # the prefill tree's int8 head (the Dream sampler's first token)
    head = jm.prefill_params["ff_out"]
    np.testing.assert_array_equal(pre["llada.prefill_head.weight_q"].numpy(),
                                  np.asarray(head["kernel_q"]).T)
    np.testing.assert_array_equal(pre["llada.prefill_head.scale"],
                                  np.asarray(head["scale"]))


def test_convert_trim_key_checked():
    """An int4 head padded to 512 columns carries __trim_N__; from_jax
    checks it against the config and the logits come out trimmed."""
    cfg = CFG.replace(llada=CFG.llada.replace(vocab_size=500,
                                              embedding_size=500))
    jm = JLaViDa.random_init(cfg, 1, jnp.bfloat16)
    jm.to_serving_layout("mixed", fuse=True)
    assert "__trim_500__" in jm.params["llada"]["ff_out"]
    tm = _port(jm)
    assert tm.llada.ff_out.out_features == 500 and tm.llada.ff_out.padded
    with torch.no_grad():
        lg, _ = tm.llada(tm.llada.embed_tokens(torch.zeros(1, 32).long()))
    assert lg.shape == (1, 32, 500)
    bad = _np(jm.params)
    bad["llada"]["ff_out"] = {**bad["llada"]["ff_out"], "__trim_499__": ()}
    del bad["llada"]["ff_out"]["__trim_500__"]
    with pytest.raises(ValueError, match="__trim_499__"):
        LaViDa.from_jax(jm.cfg, bad, "cpu",
                        prefill_params=_np(jm.prefill_params))


@pytest.mark.parametrize("where,leaf", [
    ("llada", "lora_a"), ("llada", "mystery"), ("siglip", "kernel_q")])
def test_convert_still_raises(models, where, leaf):
    """A malformed LoRA factor (a lone int8 lora_a on an int4 linear:
    well-formed factors carry across, tests/test_torch_lora.py), unknown
    names and quantized leaves outside the LM still raise, naming the
    leaf."""
    jm, _ = models
    p = _np(jm.params)
    if where == "llada":
        p["llada"]["blocks"][1]["attn_out"][leaf] = np.zeros((4,), np.int8)
        match = "attn_out"
    else:
        p["siglip"]["layers"]["fc1"][leaf] = np.zeros((2, 4), np.int8)
        match = "fc1"
    with pytest.raises(ValueError, match=match):
        state_dict_from_jax(p)


def test_prefill_tree_must_share_its_norms(models):
    jm, _ = models
    pre = _np(jm.prefill_params)
    pre["blocks"][0]["attn_norm"] = {
        "weight": pre["blocks"][0]["attn_norm"]["weight"] * 2}
    with pytest.raises(ValueError, match="attn_norm"):
        prefill_state_from_jax(pre, _np(jm.params["llada"]))


def _jax_free_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_predict_cli_mixed_runs_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "from lavida_mod_tpu_torch.predict import main; "
            "main(['--tiny', '--mixed', '--device', 'cpu', "
            "'--max-new-tokens', '32', '--step-per-block', '4'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_jax_free_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[predict] layout: mixed" in out.stdout
    assert "[predict] output ids:" in out.stdout
