"""LaViDa-Dream in the port against the JAX package on the CPU.

Dream is the LLaDA core with Qwen2's QKV bias and GQA
(lavida_mod_tpu_torch/models/dream.py) and its own sampler
(generation/dream_sampler.py).  Held here, at tiny widths:
  - the bias in its three orders, each bit-exact with the JAX function
    (`linear`: added to the rounded product in its dtype, for a float,
    a weight-only int8 and an int4 linear; `linear_act_int8`: in f32
    before the one rounding, the W8A8 kernel's epilogue; w4_qkv_norm: in
    f32 before the bf16 rounding of the epilogue, against the Pallas
    kernel in interpret mode, exact with XLA's excess precision off
    (tests/torch_jax_strict.py) and within 2 % in this process);
  - `build_dream_schedule` equal to JAX's; `sample_tokens` and
    `_commit_step` for the four algs, top-k / top-p, temperature > 0 and
    alg_temp, the random draws injected: JAX's own draws from its keys are
    fed to the port (jax.random.categorical is the argmax of logits plus
    jax.random.gumbel of the same key, asserted);
  - the Dream backbone (GQA, nonzero QKV bias) in f32: logits within
    2e-4 of max |logit| of JAX's, the cached decode likewise;
  - `dream_generate` in bf16 at temperature 0, token-exact with JAX's for
    maskgit_plus, topk_margin and entropy, with and without the hooks
    (a logits hook that bans a token, a tokens hook that pins one), and
    verbose's history;
  - the mixed layout (int8 prefill tree with its int8 head, the fused
    int4 decode plan with the bias in #5's epilogue, a 1000-row head
    padded to 1024) teacher-forced per step against JAX with
    FORCE_FUSED_INTERPRET: the prefill's first token and every step's
    shifted logits within 5 % of max |JAX logit|, every step's commits
    JAX's but for counted near-ties (`dream_teacher_forced`);
  - `LaViDa.generate` with a DreamGenerationConfig end to end (vision
    encode, splice, the sampler), token-exact with the JAX model's in
    bf16; the mixed layout's generate runs and its agreement is printed.
Card cases (skipped without CUDA) hold kernels #3 (with the bias), #5
(with the bias, and the Dream head), #6 and #7 to their plain versions at
Dream-7B's shapes:
    python -m pytest --noconftest -k cuda tests/test_torch_dream.py
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import DreamGenerationConfig as JDreamGen
from lavida_mod_tpu.config import LLaDAConfig as JLLaDAConfig
from lavida_mod_tpu.generation import dream_sampler as jds
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models.dream import dream_7b_config as jdream_7b
from lavida_mod_tpu.models.dream import tiny_dream_config as jtiny_dream
from lavida_mod_tpu.ops import quant as jq
from lavida_mod_tpu_torch.config import DreamGenerationConfig, as_port_config
from lavida_mod_tpu_torch.convert import (prefill_state_from_jax,
                                          state_dict_from_jax)
from lavida_mod_tpu_torch.generation import dream_sampler as tds
from lavida_mod_tpu_torch.models import dream as tdream
from lavida_mod_tpu_torch.models.llada import LLaDA, _run_linear
from lavida_mod_tpu_torch.ops import quant as tq
from lavida_mod_tpu_torch.ops import w4_fused as tw
from torch_jax_strict import strict_jax

torch.set_num_threads(2)


def _bf16(a):
    """f32 values that bf16 represents exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """A params tree -> {"a/b/0/c": f32 array} (bf16 values exact)."""
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + key] = np.asarray(a, np.float32)
    return out


# the child's inverse of _flat, with the leaves cast to a dtype
UNFLAT = """
def unflatten(flat, dtype):
    import jax.numpy as jnp
    tree = {}
    for key, a in flat.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(a, dtype)

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(tree)
"""


def _unflatten(flat, dtype=np.float32):
    ns = {}
    exec(UNFLAT, ns)
    return jax.tree.map(np.asarray, ns["unflatten"](flat, dtype))


def _port_lm(cfg, params, prefill=None, dtype=None):
    """The port's LLaDA module with a JAX LM params tree (and the mixed
    layout's prefill tree)."""
    sd = state_dict_from_jax({"llada": _np(params)})
    if prefill is not None:
        sd.update(prefill_state_from_jax(_np(prefill), _np(params)))
    sd = {k[len("llada."):]: v for k, v in sd.items()}
    trim = sd.pop("ff_out.__trim__", None)
    m = LLaDA(cfg, "meta")
    m.adopt_layout(sd)
    m.load_state_dict(sd, strict=True, assign=True)
    assert trim is None or int(trim) == m.ff_out.out_features
    if dtype is not None:
        for p in m.parameters():
            p.data = p.data.to(dtype)
    return m.eval()


def _dream_params(cfg, seed=0, scale=3.0, dtype=jnp.float32):
    """init_params of a Dream config, every leaf moved by seeded noise
    (the QKV biases nonzero), the matrices scaled so tokens vary; numpy
    f32 leaves holding values of `dtype`."""
    p = jl.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), p)
    p = jax.tree.map(lambda a: a * scale if a.ndim >= 3 else a, p)
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, dtype).astype(jnp.float32)), p)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_dream_configs_and_ids_equal_jax():
    from lavida_mod_tpu.models import dream as jdream

    assert as_port_config(jdream_7b()) == tdream.dream_7b_config()
    assert as_port_config(jtiny_dream()) == tdream.tiny_dream_config()
    assert as_port_config(jtiny_dream(n_kv_heads=4)) == \
        tdream.tiny_dream_config(n_kv_heads=4)
    for name in ("DREAM_MASK_ID", "DREAM_PAD_ID", "DREAM_EOS_ID"):
        assert getattr(tdream, name) == getattr(jdream, name)
    c = tdream.dream_7b_config()
    assert (c.mask_token_id, c.eos_token_id) == (tdream.DREAM_MASK_ID,
                                                 tdream.DREAM_EOS_ID)


def test_dream_names_map_as_the_jax_converter():
    """Every HF Dream name the JAX converter reads maps onto the port's
    LLaDA module; anything else raises or is left to the other parts."""
    cfg = tdream.tiny_dream_config()
    names = dict(LLaDA(cfg, "meta").named_parameters())
    state = {"model.embed_tokens.weight": 0, "model.norm.weight": 0,
             "lm_head.weight": 0, "model.vision_tower.x": 0}
    for i in range(cfg.n_layers):
        for src in tdream._LINEARS:
            state[f"model.layers.{i}.{src}.weight"] = 0
        for src in ("q_proj", "k_proj", "v_proj"):
            state[f"layers.{i}.self_attn.{src}.bias"] = 0
        for src in tdream._NORMS:
            state[f"model.layers.{i}.{src}.weight"] = 0
    plan = tdream.lm_plan(state, cfg)
    assert set(plan) == set(names)
    assert "model.vision_tower.x" not in plan.values()
    for bad, why in (("model.layers.0.self_attn.o_proj.bias", "q/k/v"),
                     ("model.layers.2.mlp.up_proj.weight", "2-layer"),
                     ("model.layers.0.mlp.fc3.weight", "2-layer")):
        with pytest.raises(ValueError, match=why):
            tdream.port_name(bad, cfg)


# ---------------------------------------------------------------------------
# the bias in its three orders
# ---------------------------------------------------------------------------

def _lin_case(seed, K=256, N=384, T=12, integer=False):
    """(x, JAX linear params, the nn.Linear); `integer`: x of small
    integers, so an f32 product with int8 codes is exact in any order."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (T, K)).astype(np.float32) if integer
         else _bf16(rng.standard_normal((T, K))))
    w = _bf16(rng.standard_normal((K, N)) * 0.05)
    b = _bf16(rng.standard_normal(N))
    lin = torch.nn.Linear(K, N, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    return x, {"kernel": jnp.asarray(w, jnp.bfloat16),
               "bias": jnp.asarray(b, jnp.bfloat16)}, lin


@pytest.mark.parametrize("kind", ["float", "int8", "int8_f32", "int4",
                                  "act_int8"])
def test_bias_order_bit_exact_with_jax(kind):
    """`linear` adds the bias to the rounded product in the result's dtype
    (quant.py:185-186); `linear_act_int8` adds it in f32 before its one
    rounding (quant.py:226-230): the port's linears do the same, bit for
    bit, and the two orders do differ on these inputs."""
    # int8_f32: the f32 product, whose sum order XLA and PyTorch do not
    # share, made exact by integer activations
    x, p, lin = _lin_case(1, integer=kind == "int8_f32")
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    pref = jnp.float32 if kind == "int8_f32" else None
    with torch.no_grad():
        if kind == "float":
            want, got = jq.linear(xj, p), _run_linear(lin, xt)
        elif kind in ("int8", "int8_f32"):
            want = jq.linear(xj, jq.quantize_linear(p), preferred=pref)
            got = tq.Int8Linear.from_linear(lin)(
                xt, preferred=torch.float32 if pref else None)
        elif kind == "int4":
            want = jq.linear(xj, jq.quantize_linear4(p))
            got = tq.Int4Linear.from_linear(lin)(xt)
        else:
            want = jq.linear_act_int8(xj, jq.quantize_linear(p))
            got = tq.Int8Linear.from_linear(lin)(xt, act_int8=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == (torch.float32 if pref else torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if kind == "act_int8":
        # the other order (the bf16 product, then a bf16 add) differs
        q = jq.quantize_linear({"kernel": p["kernel"]})
        other = jq.linear_act_int8(xj, q) + p["bias"]
        assert not np.array_equal(np.asarray(other.astype(jnp.float32)),
                                  want)


QKV_BIAS_CASES = [dict(T=16, D=256, N=384), dict(T=32, D=512, N=1024)]

# the JAX side of #5 with its bias: the Pallas kernel in interpret mode
JAX_QKV = """
import jax.numpy as jnp
from lavida_mod_tpu.ops.w4_fused import w4_qkv_norm

def jax_qkv(a):
    b = lambda k: jnp.asarray(a[k], jnp.bfloat16)
    out = w4_qkv_norm(b("x"), b("nw"), jnp.asarray(a["packed"]),
                      jnp.asarray(a["scales"]), bias=b("bias"), eps=1e-5,
                      block_n=128, interpret=True)
    return np.asarray(out.astype(jnp.float32))
"""


def _qkv_inputs(seed, T, D, N):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((D, N)).astype(np.float32) * 0.05
    packed, scales = tq.quantize_w4_grouped(w)
    return dict(x=_bf16(rng.standard_normal((T, D))),
                nw=_bf16(1 + 0.1 * rng.standard_normal(D)),
                bias=_bf16(rng.standard_normal(N)),
                packed=packed, scales=scales)


def _qkv_port(a, fma=False):
    """The port's #5 on `a`; fma: its epilogue as one fused multiply-add,
    acc * sx + bias rounded once to f32 (computed in f64: the product of
    two f32 is exact there), as XLA's CPU backend contracts it."""
    b = lambda k: torch.from_numpy(a[k]).bfloat16()        # noqa: E731
    w = tq.pack_w4_frag(torch.from_numpy(tq.unpack_w4_jax(a["packed"])))
    s = torch.from_numpy(a["scales"])
    if fma:
        x8, sx = tw.rms_quant(b("x"), b("nw"), 1e-5)
        acc = tw.group_dot_acc(x8, w, s).double() * sx.double()
        y = (acc + b("bias").double()).float()
        return y.bfloat16().float().numpy()
    return tw.w4_qkv_norm(b("x"), b("nw"), w, s, 1e-5,
                          b("bias")).float().numpy()


@pytest.mark.parametrize("i", range(len(QKV_BIAS_CASES)))
def test_qkv_norm_bias_within_band_of_jax_kernel(i):
    ns = {"np": np}
    exec(JAX_QKV, ns)
    a = _qkv_inputs(i, **QKV_BIAS_CASES[i])
    got, want = _qkv_port(a), ns["jax_qkv"](a)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 0.02 * np.abs(want).max()


def test_qkv_norm_bias_bit_exact_without_excess_precision(tmp_path):
    """#5's plain version with the bias against the Pallas kernel, XLA's
    excess precision off.  The two reduce the RMSNorm's sum of squares in
    different orders, so a row's int8 codes can flip on a rounding
    boundary (with or without a bias), and XLA's CPU backend contracts
    acc * sx + bias into one fused multiply-add (the port, like the CUDA
    kernel, rounds the product first): on every row whose no-bias result
    is bit-exact, each element is the port's or, where the two roundings
    differ, the fused multiply-add's (counted); such rows are the rule,
    and all rows stay in the 2 % band."""
    inputs = {}
    for i, d in enumerate(QKV_BIAS_CASES):
        inputs.update({f"{i}/{k}": v for k, v in _qkv_inputs(i, **d).items()})
    ref = strict_jax(JAX_QKV + f"""
for i in range({len(QKV_BIAS_CASES)}):
    a = {{k.split("/", 1)[1]: v for k, v in IN.items()
         if k.startswith(f"{{i}}/")}}
    OUT[str(i)] = jax_qkv(a)
    a["bias"] = np.zeros_like(a["bias"])
    OUT[f"{{i}}/nobias"] = jax_qkv(a)
""", tmp_path, inputs)
    for i, d in enumerate(QKV_BIAS_CASES):
        a = _qkv_inputs(i, **d)
        got, want = _qkv_port(a), ref[str(i)]
        a["bias"] = np.zeros_like(a["bias"])
        same = (_qkv_port(a) == ref[f"{i}/nobias"]).all(axis=1)
        assert same.mean() >= 0.75, same
        a["bias"] = _qkv_inputs(i, **d)["bias"]
        fma = _qkv_port(a, fma=True)
        off = got[same] != want[same]
        np.testing.assert_array_equal(fma[same][off], want[same][off])
        assert off.sum() <= 1e-3 * off.size, off.sum()
        print(f"case {i}: {int(off.sum())} of {off.size} elements are the "
              f"fused multiply-add's rounding")
        assert not np.array_equal(got[same], ref[f"{i}/nobias"][same])
        assert np.abs(got - want).max() < 0.02 * np.abs(want).max()


def test_w8a8_bias_in_the_epilogue():
    """The W8A8 plain version adds the bias in f32 before its rounding:
    `linear_act_int8`'s CPU math in the JAX package."""
    from lavida_mod_tpu_torch.ops import w8a8 as t8

    x, p, lin = _lin_case(2, K=384, N=256, T=9)
    q8, sc = tq.quantize_linear(lin.weight)
    x8, sx = t8.act_quant(torch.from_numpy(x).bfloat16(), t8.ACT_FORMULA_W8)
    got = t8.w8a8_matmul(x8, sx, q8, sc, lin.bias.detach())
    want = jq.linear_act_int8(jnp.asarray(x, jnp.bfloat16),
                              jq.quantize_linear(p))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    no_bias = t8.w8a8_matmul(x8, sx, q8, sc)
    assert torch.equal(no_bias, t8.w8a8_matmul_reference(x8, sx, q8, sc))


# ---------------------------------------------------------------------------
# the sampler's pieces
# ---------------------------------------------------------------------------

SCHEDULES = [dict(max_new_tokens=32, steps=16, alg="topk_margin"),
             dict(max_new_tokens=32, steps=512, alg="entropy"),
             dict(max_new_tokens=16, steps=16, alg="origin"),
             dict(max_new_tokens=64, steps=24, alg="maskgit_plus",
                  schedule="shift", schedule_shift=0.33),
             dict(max_new_tokens=32, steps=16, alg="topk_margin",
                  schedule="cosine"),
             dict(max_new_tokens=32, steps=32, alg="entropy",
                  step_ratio=0.5),
             dict(max_new_tokens=8, steps=64, alg="maskgit_plus",
                  step_ratio=4.0),
             dict(max_new_tokens=20, steps=7, alg="topk_margin",
                  prefix_lm=False)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_build_dream_schedule_equals_jax(kw):
    ts, ks, steps = tds.build_dream_schedule(DreamGenerationConfig(**kw),
                                             kw["max_new_tokens"])
    jts, jks, jsteps = jds.build_dream_schedule(JDreamGen(**kw),
                                                kw["max_new_tokens"])
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(ks, jks)
    assert steps == jsteps


ALGS = ["origin", "maskgit_plus", "topk_margin", "entropy"]
FLAGS = {"origin": {}, "maskgit_plus": {},
         "topk_margin": dict(margin_confidence=True),
         "entropy": dict(neg_entropy=True)}


def _logits(seed, shape=(2, 6, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("temperature,top_p,top_k", [
    (0.0, None, None), (0.7, None, None), (1.3, 0.9, None),
    (0.5, None, 5), (0.0, 0.8, 8)])
def test_sample_tokens_equal_jax(alg, temperature, top_p, top_k):
    logits = _logits(3)
    key = jax.random.PRNGKey(7)
    conf_j, x0_j = jds.sample_tokens(jnp.asarray(logits), key, temperature,
                                     top_p, top_k, **FLAGS[alg])
    g = None
    if temperature > 0:
        # JAX's categorical draw is argmax(logits + gumbel of its key)
        tl = jds._filter_logits(jnp.asarray(logits) / temperature, top_p,
                                top_k)
        gj = jax.random.gumbel(key, logits.shape)
        assert (jnp.argmax(tl + gj, -1) == x0_j).all()
        g = torch.from_numpy(np.asarray(gj))
    conf_t, x0_t = tds.sample_tokens(torch.from_numpy(logits), temperature,
                                     top_p, top_k, gumbel_noise=g,
                                     **FLAGS[alg])
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(x0_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("temperature,alg_temp", [(0.0, None), (0.8, None),
                                                  (0.0, 0.5)])
def test_commit_step_with_injected_noise_equals_jax(alg, temperature,
                                                    alg_temp):
    """`_commit_step` with JAX's own draws of keys ks (the categorical
    draw's Gumbel noise) and kt (origin's uniforms, alg_temp's Gumbel
    uniforms) injected gives JAX's tokens."""
    B, G, V = 2, 12, 64
    logits = _logits(5, (B, G, V))
    rng = np.random.default_rng(9)
    x = np.where(rng.random((B, G)) < 0.7, 60, rng.integers(0, 50, (B, G)))
    mask = x == 60
    ks, kt = jax.random.split(jax.random.PRNGKey(11))
    want = jds._commit_step(
        jnp.asarray(x, jnp.int32), jnp.asarray(logits), jnp.asarray(mask),
        jnp.int32(3), jnp.float32(0.4), ks, kt, alg, alg_temp, temperature,
        None, None)
    g = u = None
    if temperature > 0:
        g = torch.from_numpy(np.asarray(
            jax.random.gumbel(ks, (B, G, V))))
    if alg == "origin":
        u = torch.from_numpy(np.asarray(jax.random.uniform(kt, (B, G))))
    elif alg_temp:
        u = torch.from_numpy(np.asarray(jax.random.uniform(
            kt, (B, G), minval=1e-20)))
    got = tds._commit_step(
        torch.from_numpy(x).long(), torch.from_numpy(logits),
        torch.from_numpy(mask), torch.tensor(3), torch.tensor(0.4),
        alg, alg_temp, temperature, None, None, noise=(g, u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != x).any()


# ---------------------------------------------------------------------------
# the Dream backbone in f32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_f32():
    cfg = jtiny_dream()
    p = _dream_params(cfg)
    return cfg, p, _port_lm(tdream.tiny_dream_config(), p)


def test_dream_backbone_f32_equals_jax(tiny_f32):
    cfg, p, m = tiny_f32
    assert float(np.abs(p["blocks"]["q_proj"]["bias"]).max()) > 0.01
    ids = np.arange(5, 29)[None]
    want, _ = jl.forward(p, cfg, jl.embed_tokens(p, jnp.asarray(ids)))
    with torch.no_grad():
        got, _ = m(m.embed_tokens(torch.from_numpy(ids)))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() < 2e-4 * np.abs(want).max()


def test_dream_cached_decode_f32_equals_jax(tiny_f32):
    """Prefill into preallocated buffers, then a decode at kv_write_index
    P: the logits of JAX's same calls."""
    cfg, p, m = tiny_f32
    p = jl.unstack_blocks(p)
    P, G = 10, 6
    prompt, gen = np.arange(3, 3 + P)[None], np.arange(100, 100 + G)[None]
    z = jnp.zeros((1, P + G, cfg.effective_n_kv_heads, cfg.head_dim))
    last, cache = jl.forward(p, cfg, jl.embed_tokens(p, jnp.asarray(prompt)),
                             kv_cache=[(z, z)] * cfg.n_layers,
                             kv_write_index=jnp.asarray(0, jnp.int32),
                             use_cache=True, last_logits_only=True)
    want, _ = jl.forward(p, cfg, jl.embed_tokens(p, jnp.asarray(gen)),
                         positions=jnp.arange(P, P + G), kv_cache=cache,
                         kv_write_index=P, use_cache=True)
    with torch.no_grad():
        x, tcache = tds._prefill(m, m.embed_tokens(torch.from_numpy(prompt)),
                                 G, False, False)
        got, _ = m(m.embed_tokens(torch.from_numpy(gen)),
                   positions=torch.arange(P, P + G), kv_cache=tcache,
                   kv_write_index=P, use_cache=True)
    assert int(x[0, 0]) == int(jnp.argmax(last[0, -1]))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() < 2e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# whole generations in bf16, with the hooks
# ---------------------------------------------------------------------------

BAN, PIN = 7, (3, 11)
GENS = {alg: dict(max_new_tokens=16, steps=8, alg=alg)
        for alg in ("maskgit_plus", "topk_margin", "entropy")}


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """JAX's Dream generations of a tiny bf16 model in the strict child:
    the fused path per alg, the hooked path with a token ban and a pinned
    token, and verbose's history."""
    cfg = jtiny_dream()
    p = _dream_params(cfg, seed=1, dtype=jnp.bfloat16)
    prefix = _bf16(np.random.default_rng(2).standard_normal((1, 12, 64)))
    inputs = {**_flat(p, "p/"), "prefix": prefix}
    ref = strict_jax(UNFLAT + f"""
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import DreamGenerationConfig
from lavida_mod_tpu.generation.dream_sampler import dream_generate
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models.dream import tiny_dream_config

cfg = tiny_dream_config()
p = jl.unstack_blocks(unflatten({{k[2:]: v for k, v in IN.items()
                                  if k.startswith("p/")}}, jnp.bfloat16))
prefix = jnp.asarray(IN["prefix"], jnp.bfloat16)
gens = {GENS!r}
for alg, kw in gens.items():
    OUT[alg] = np.asarray(dream_generate(p, cfg, prefix,
                                         DreamGenerationConfig(**kw)))
gen = DreamGenerationConfig(**gens["topk_margin"])
def ban(step, x, logits):
    return logits.at[..., {BAN}].set(-jnp.inf)
def pin(step, x, logits):
    return x.at[:, {PIN[0]}].set({PIN[1]})
OUT["hooked"] = np.asarray(dream_generate(p, cfg, prefix, gen,
                                          logits_hook=ban, tokens_hook=pin))
x, hist = dream_generate(p, cfg, prefix, gen, verbose=True)
OUT["verbose"], OUT["history"] = np.asarray(x), np.stack(hist)
""", tmp_path_factory.mktemp("strict"), inputs)
    m = _port_lm(tdream.tiny_dream_config(), p, dtype=torch.bfloat16)
    return ref, m, torch.from_numpy(prefix).bfloat16()


@pytest.mark.parametrize("alg", sorted(GENS))
def test_dream_generate_bf16_token_exact(bf16_run, alg):
    ref, m, prefix = bf16_run
    got = tds.dream_generate(m, prefix, DreamGenerationConfig(**GENS[alg]))
    np.testing.assert_array_equal(got.numpy(), ref[alg])
    assert len(set(ref[alg][0].tolist())) >= 4, "degenerate"
    assert (got != m.cfg.mask_token_id).all()


def test_dream_hooks_and_verbose_as_jax(bf16_run):
    ref, m, prefix = bf16_run
    gen = DreamGenerationConfig(**GENS["topk_margin"])

    def ban(step, x, logits):
        logits = logits.clone()
        logits[..., BAN] = -math.inf
        return logits

    def pin(step, x, logits):
        x = x.clone()
        x[:, PIN[0]] = PIN[1]
        return x

    hooked = tds.dream_generate(m, prefix, gen, logits_hook=ban,
                                tokens_hook=pin)
    np.testing.assert_array_equal(hooked.numpy(), ref["hooked"])
    assert int(hooked[0, PIN[0]]) == PIN[1] and (hooked != BAN).all()
    x, hist = tds.dream_generate(m, prefix, gen, verbose=True)
    np.testing.assert_array_equal(x.numpy(), ref["verbose"])
    np.testing.assert_array_equal(np.stack(hist), ref["history"])
    # identity hooks: the hooked loop is the fused loop's tokens
    ident = tds.dream_generate(m, prefix, gen,
                               tokens_hook=lambda s, x, lg: x,
                               logits_hook=lambda s, x, lg: lg)
    np.testing.assert_array_equal(ident.numpy(), ref["topk_margin"])
    with pytest.raises(NotImplementedError, match="hook-free"):
        tds.dream_generate(m, prefix, gen, verbose=True,
                           act_int8_prefill=True)
    with pytest.raises(NotImplementedError, match="prefix-cache"):
        tds.dream_generate(m, prefix, gen.replace(prefix_lm=False))


def test_dream_origin_and_sampling_complete(bf16_run):
    """The random paths (origin's draws, temperature, alg_temp) from a
    torch.Generator: every position committed, reproducible by seed."""
    _, m, prefix = bf16_run
    for kw in (dict(alg="origin"), dict(alg="topk_margin", temperature=0.8,
                                         top_p=0.9),
               dict(alg="entropy", alg_temp=0.3, top_k=20)):
        gen = DreamGenerationConfig(max_new_tokens=16, steps=8, **kw)
        outs = [tds.dream_generate(
            m, prefix, gen, generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
        assert torch.equal(outs[0], outs[1])
        assert (outs[0] != m.cfg.mask_token_id).all(), kw


# ---------------------------------------------------------------------------
# the mixed layout, teacher-forced
# ---------------------------------------------------------------------------

MIXED_CFG = dict(d_model=512, n_heads=4, n_kv_heads=2, n_layers=2,
                 mlp_hidden_size=1536, block_type="llama",
                 activation="silu", include_qkv_bias=True, vocab_size=1000,
                 embedding_size=1000, mask_token_id=990, eos_token_id=991,
                 pad_token_id=991, max_sequence_length=256,
                 rope_theta=10000.0, rms_norm_eps=1e-6, weight_tying=False)
MIXED_GEN = dict(max_new_tokens=32, steps=16, alg="topk_margin")

# JAX's mixed Dream loop replayed one step at a time in the strict child
# (the unrolled write-index branch of _dream_fused with the int8 prefill
# tree, flash prefill and the fused decode plan in interpret mode)
JAX_MIXED = UNFLAT + f"""
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import DreamGenerationConfig, LLaDAConfig
from lavida_mod_tpu.generation import dream_sampler as jds
from lavida_mod_tpu.models import llada as jl

jl.FORCE_FUSED_INTERPRET = True
cfg = LLaDAConfig(**{MIXED_CFG!r})
lp = jl.unstack_blocks(unflatten({{k[2:]: v for k, v in IN.items()
                                   if k.startswith("p/")}}, jnp.bfloat16))
lp, fcfg = jl.to_fused_layout(lp, cfg)
pre = jl.quantize_params(lp, bits=8)
dec = jl.quantize_params(lp, bits=4)
assert "bias" in dec["blocks"][0]["att_proj"]
assert jl._w4_fused_plan(fcfg, dec["blocks"][0], 32, False) is not None
assert jl._w4_head_fusable(fcfg, dec, dec["ff_out"], 32)
for name, tree in (("dec", dec), ("pre", pre)):
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        OUT[name + "/" + key] = np.asarray(
            a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
gen = DreamGenerationConfig(**{MIXED_GEN!r})
G = gen.max_new_tokens
prefix = jnp.asarray(IN["prefix"], jnp.bfloat16)
B, P, _ = prefix.shape
z = jnp.zeros((B, P + G, fcfg.effective_n_kv_heads, fcfg.head_dim),
              jnp.bfloat16)
last, cache = jl.forward(pre, fcfg, prefix, kv_cache=[(z, z)] * 2,
                         kv_write_index=jnp.asarray(0, jnp.int32),
                         use_cache=True, last_logits_only=True,
                         use_flash=True, act_int8=True)
OUT["first_logits"] = np.asarray(last[:, -1])
x = jnp.full((B, G), fcfg.mask_token_id, jnp.int32)
x = x.at[:, 0].set(jnp.argmax(last[:, -1], axis=-1).astype(jnp.int32))
_, ks_table, steps = jds.build_dream_schedule(gen, G)
key = jax.random.PRNGKey(0)
xs, lgs, jax_self = [np.asarray(x)], [], []
for i in range(steps):
    key, ks, kt = jax.random.split(key, 3)
    mask_index = x == fcfg.mask_token_id
    logits, cache = jl.forward(dec, fcfg, jl.embed_tokens(dec, x),
                               positions=jnp.arange(P, P + G),
                               kv_cache=cache, kv_write_index=P,
                               use_cache=True)
    logits = jnp.concatenate([logits[:, :1], logits[:, :-1]], axis=1)
    # the same step through JAX's unfused int4 decode, for the band
    jl.FORCE_FUSED_INTERPRET = False
    plain, _ = jl.forward(dec, fcfg, jl.embed_tokens(dec, x),
                          positions=jnp.arange(P, P + G), kv_cache=cache,
                          kv_write_index=P, use_cache=True)
    jl.FORCE_FUSED_INTERPRET = True
    plain = jnp.concatenate([plain[:, :1], plain[:, :-1]], axis=1)
    jax_self.append(float(jnp.abs(plain - logits).max()
                          / jnp.abs(logits).max()))
    x = jds._commit_step(x, logits, mask_index, jnp.int32(ks_table[i]),
                         jnp.float32(0.0), ks, kt, gen.alg, None, 0.0,
                         None, None)
    xs.append(np.asarray(x))
    lgs.append(np.asarray(logits))
OUT["xs"], OUT["logits"] = np.stack(xs), np.stack(lgs)
OUT["jax_self"] = np.asarray(jax_self)
"""


def dream_teacher_forced(model, prefix, gen, xs, jax_logits, first_logits,
                         jax_self, band=0.05):
    """The port's half of a teacher-forced Dream comparison (the Dream
    counterpart of torch_jax_strict.teacher_forced, for topk_margin at
    temperature 0).  The port prefills as its mixed path does; its first
    token is JAX's unless JAX's top two prefill logits are within 2 delta
    (delta the largest |logit difference|).  Then from each of JAX's
    buffers x_t one port step: the shifted logits within `band` of
    max |JAX logit| (or, where larger, of the largest gap between JAX's
    own fused and unfused int4 decodes of the same steps, `jax_self`:
    the port is to be no farther from JAX's kernels than JAX's other
    int4 path is), and the commits JAX's, except where the k-th and
    (k+1)-th margins of the row are within 2 (e^(2 delta) - 1) of each
    other (a logit moved by delta moves each probability by a factor
    within e^(+-2 delta)), or, for a token, where the top two logits are
    within 2 delta.  Returns the near-tie exceptions."""
    G = gen.max_new_tokens
    P = prefix.shape[1]
    mask = model.cfg.mask_token_id
    band = max(band, float(np.max(jax_self)))
    with torch.no_grad():
        first, cache = tds._prefill(model, prefix, G, True, True)
        lg, _ = model(prefix, kv_cache=[(torch.zeros_like(k),
                                         torch.zeros_like(v))
                                        for k, v in cache],
                      kv_write_index=0, use_cache=True,
                      last_logits_only=True, use_flash=True, act_int8=True)
    ref = torch.from_numpy(first_logits)
    delta = (lg[:, -1] - ref).abs().max().item()
    assert delta < band * ref.abs().max().item()
    exceptions = []
    if int(first[0, 0]) != int(xs[0][0, 0]):
        top2 = torch.topk(ref[0], 2).values
        assert (top2[0] - top2[1]).item() <= 2 * delta
        exceptions.append(("first", round((top2[0] - top2[1]).item(), 4)))
    _, ks, steps = tds.build_dream_schedule(gen, G)
    for i in range(steps):
        x = torch.from_numpy(xs[i]).long()
        with torch.no_grad():
            logits = tds._shifted_logits(model, x, cache, P)
        ref = torch.from_numpy(jax_logits[i])
        rel = ((logits - ref).abs().max() / ref.abs().max()).item()
        assert rel < band, (i, rel, band)
        new = tds._commit_step(x, logits, x == mask, torch.tensor(ks[i]),
                               torch.tensor(0.0), gen.alg, None, 0.0, None,
                               None)
        want = torch.from_numpy(xs[i + 1]).long()
        for b in range(x.shape[0]):
            d = (logits[b] - ref[b]).abs().max().item()
            got_set, want_set = new[b] != x[b], want[b] != x[b]
            if not torch.equal(got_set, want_set):
                conf, _ = tds.sample_tokens(ref[b], margin_confidence=True)
                top = torch.sort(conf[x[b] == mask], descending=True).values
                k = int(ks[i])
                gap = (top[k - 1] - top[k]).item() if k < len(top) else 0.0
                bound = 2 * math.expm1(2 * d)
                assert gap <= bound, (i, b, gap, bound)
                exceptions.append((i, b, round(gap, 4), round(bound, 4)))
                continue
            for t in torch.nonzero(got_set & (new[b] != want[b]))[:, 0]:
                top2 = torch.topk(ref[b, t], 2).values
                gap = (top2[0] - top2[1]).item()
                assert gap <= 2 * d, (i, b, t)
                exceptions.append((i, b, round(gap, 4), round(2 * d, 4)))
    return exceptions


def test_dream_mixed_teacher_forced_against_jax(tmp_path):
    """The fused decode kernels' plain versions are not bit-exact with the
    interpret-mode Pallas kernels (tests/test_torch_mixed.py's note: the
    SwiGLU's exp, code flips on rounding boundaries); through this model
    the logits differ by 2.5-5.3 % of max |logit| per step, with or
    without the bias and GQA alike, where JAX's own unfused int4 decode
    differs from its fused kernels by 4.7-6.6 %: that gap is the band
    where it exceeds 5 % (`dream_teacher_forced`)."""
    cfg = JLLaDAConfig(**MIXED_CFG)
    p = _dream_params(cfg, seed=3, scale=2.0, dtype=jnp.bfloat16)
    prefix = _bf16(np.random.default_rng(4).standard_normal((1, 40, 512)))
    ref = strict_jax(JAX_MIXED, tmp_path, {**_flat(p, "p/"),
                                           "prefix": prefix})
    dec = _unflatten({k[4:]: v for k, v in ref.items()
                      if k.startswith("dec/")}, None)
    pre = _unflatten({k[4:]: v for k, v in ref.items()
                      if k.startswith("pre/")}, None)
    # the JAX int4 head's __trim_1000__ key holds no array
    dec["ff_out"]["__trim_1000__"] = ()
    fcfg = as_port_config(jl.to_fused_layout(
        jl.unstack_blocks(jl.init_params(cfg, jax.random.PRNGKey(0))),
        cfg)[1])
    m = _port_lm(fcfg, dec, pre, dtype=torch.bfloat16)
    blk = m.blocks[0]
    assert blk.fused_plan(32, False) and m.head_fusable(32)
    assert blk.att_proj.bias is not None and m.ff_out.padded
    assert blk.prefill["att_proj"].bias is not None
    assert isinstance(m.prefill_head, tq.Int8Linear)
    gen = DreamGenerationConfig(**MIXED_GEN)
    xs = ref["xs"]
    assert len(set(xs[-1][0].tolist())) >= 4, "degenerate"
    ties = dream_teacher_forced(m, torch.from_numpy(prefix).bfloat16(), gen,
                                xs, ref["logits"], ref["first_logits"],
                                ref["jax_self"])
    got = tds.dream_generate(m, torch.from_numpy(prefix).bfloat16(), gen,
                             use_flash_prefill=True, act_int8_prefill=True)
    assert (got != fcfg.mask_token_id).all() and got.shape == (1, 32)
    print(f"near-tie exceptions (step, row, gap, bound): {ties}; "
          f"free-running agreement with JAX's replay "
          f"{float((got.numpy() == xs[-1]).mean()):.2f}")


def test_dream_fused_gates():
    """The fused plan takes a bias on att_proj only, and the head none."""
    cfg = tdream.tiny_dream_config(d_model=512, n_heads=4, n_kv_heads=2,
                                   mlp_hidden_size=1536, vocab_size=1000,
                                   embedding_size=1000, mask_token_id=990)
    m = LLaDA(cfg, "cpu", torch.bfloat16)
    m.to_fused_layout()
    m.add_prefill_tree()
    m.quantize(4)
    blk = m.blocks[0]
    assert blk.fused_plan(32, False) and m.head_fusable(32)
    blk.attn_out.bias = torch.nn.Parameter(torch.zeros(512))
    assert not blk.fused_plan(32, False)
    m.ff_out.bias = torch.nn.Parameter(torch.zeros(1000))
    assert not m.head_fusable(32)


# ---------------------------------------------------------------------------
# LaViDa.generate end to end
# ---------------------------------------------------------------------------

LAVIDA = """
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_siglip_config)
from lavida_mod_tpu.models.dream import tiny_dream_config

CFG = LaViDaConfig(
    llada=tiny_dream_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
"""
LAVIDA_GEN = dict(max_new_tokens=16, steps=8, alg="topk_margin")


def _lavida_params():
    ns = {}
    exec(LAVIDA, ns)
    from lavida_mod_tpu.models import multimodal as jmm

    p = jmm.init_params(ns["CFG"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), p)
    p["llada"] = jax.tree.map(lambda a: a * 3 if a.ndim >= 3 else a,
                              p["llada"])
    return ns["CFG"], jax.tree.map(lambda a: _bf16(a), p)


def test_lavida_generate_dream_end_to_end(tmp_path):
    """`LaViDa.generate` with a DreamGenerationConfig: the port's prefix
    (vision encode, projector, splice) is JAX's, its text rows exactly and
    its image rows up to a bf16 rounding of single elements (XLA's erf and
    reductions against PyTorch's; tests/test_torch_mixed.py's note), and
    from JAX's prefix the port's sampler gives JAX's tokens exactly; the
    port's generate is its encode_prompt and dream_generate.
    The mixed layout's generate runs; its agreement with JAX's is
    printed."""
    from lavida_mod_tpu.data.anyres import anyres_grid_shape
    from lavida_mod_tpu_torch.models.lavida import LaViDa

    cfg, p = _lavida_params()
    nw, nh = anyres_grid_shape((100, 60), cfg.vision.grid_pinpoints, 56)
    rng = np.random.default_rng(8)
    views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9, 10])
    ref = strict_jax(LAVIDA + UNFLAT + f"""
from lavida_mod_tpu.config import DreamGenerationConfig
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.models.lavida import LaViDa
from lavida_mod_tpu.ops.short_attention import short_attention

jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
params = unflatten({{k[2:]: v for k, v in IN.items() if k.startswith("p/")}},
                   jnp.bfloat16)
jm = LaViDa(CFG, params, "dream")
gen = DreamGenerationConfig(**{LAVIDA_GEN!r})
OUT["tokens"] = jm.generate(IN["ids"], [IN["views"]], [(100, 60)], gen)
OUT["prefix"] = np.asarray(jm.encode_prompt(
    IN["ids"], [IN["views"]], [(100, 60)]).astype(jnp.float32))
jm.to_serving_layout("mixed", fuse=True)
OUT["mixed"] = jm.generate(IN["ids"], [IN["views"]], [(100, 60)], gen)
""", tmp_path, {**_flat(p, "p/"), "ids": ids, "views": views})
    tm = LaViDa.from_jax(cfg, p, "cpu", dtype=torch.bfloat16,
                         lm_family="dream")
    assert tm.lm_family == "dream"
    gen = DreamGenerationConfig(**LAVIDA_GEN)
    prefix = tm.encode_prompt(ids, [views], [(100, 60)])
    want = torch.from_numpy(ref["prefix"])
    off = prefix.float() != want
    diff = (prefix.float() - want).abs()
    assert prefix.shape == want.shape and not off[0, :2].any()
    assert diff.max() <= 2 ** -7 * want.abs().max()
    assert diff.mean() < 1e-3 * want.abs().max()
    from_jax_prefix = tds.dream_generate(tm.llada, want.bfloat16(), gen)
    np.testing.assert_array_equal(from_jax_prefix[0].numpy(), ref["tokens"])
    assert len(set(ref["tokens"].tolist())) >= 4, "degenerate"
    got = tm.generate(ids, [views], [(100, 60)], gen)
    np.testing.assert_array_equal(
        got, tds.dream_generate(tm.llada, prefix, gen)[0].numpy())
    with pytest.raises(NotImplementedError, match="bucketing"):
        tm.generate(ids, [views], [(100, 60)], gen, prefix_bucket=64)
    tm.to_serving_layout("mixed", fuse=True)
    assert tm.mixed and tm.llada.prefill_head is not None
    mixed = tm.generate(ids, [views], [(100, 60)], gen)
    assert mixed.shape == (16,) and (mixed != cfg.llada.mask_token_id).all()
    print(f"LaViDa-Dream generate: prefix elements off JAX's "
          f"{int(off.sum())}, free-running agreement bf16 "
          f"{float((got == ref['tokens']).mean()):.2f}, mixed "
          f"{float((mixed == ref['mixed']).mean()):.2f} (the tiny widths "
          f"pad the int4 linears: its decode is the unfused int4 path)")


def test_adapter_dream_generate_until_and_loglikelihood():
    from lavida_mod_tpu_torch.eval import adapter as tadapter
    from lavida_mod_tpu_torch.models.lavida import LaViDa

    cfg, p = _lavida_params()
    tm = LaViDa.from_jax(cfg, p, "cpu", dtype=torch.bfloat16,
                         lm_family="dream")

    class Tok:
        chat_template = None

        def __call__(self, text):
            class E:
                input_ids = [3 + (ord(c) % 200) for c in text]
            return E()

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(i) for i in ids)

    from PIL import Image

    img = Image.fromarray(np.random.default_rng(1).integers(
        0, 255, (60, 100, 3), dtype=np.uint8))
    ev = tadapter.LavidaEvalModel(tm, Tok())
    kw = {"max_new_tokens": 16, "steps": 8}
    text = ev.generate_until("Describe.", [img], kw)
    ids, views, sizes, model = ev._build_inputs("Describe.", [img])
    gen = tadapter.gen_kwargs_to_config(kw, "dream")
    want = model.decode_output(model.generate(ids, views, sizes, gen), Tok(),
                               ev._stop_ids())
    assert text == want and len(ev.latencies) == 1
    with pytest.raises(NotImplementedError, match="Dream backbone"):
        ev.loglikelihood("q", [img], "a")
    with pytest.raises(NotImplementedError, match="LLaDA sampler"):
        ev.generate_until_batch(["q"], [[img]], kw)


# ---------------------------------------------------------------------------
# the kernels at Dream-7B's shapes on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_w4(K, N, gen, device, Kp=None):
    w = torch.randn(N, K, generator=gen, device=device) * 0.02
    if Kp is not None:
        w = torch.nn.functional.pad(w, (0, Kp - K))
    packed, scales, _ = tq.quantize_linear4(w)
    return packed[:N // 8].contiguous(), scales[:, :N].contiguous()


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("N,bias", [(4608, True), (152064, False),
                                    (152064, True)])
def test_qkv_norm_bias_kernel_at_dream_shapes_on_cuda(cuda, N, bias):
    """#5 at [32, 3584] x 4608 with the QKV bias and at the head padded to
    152064 columns, within #5's 1e-2 band; without a bias the kernel's
    result is the no-bias entry's, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(0)
    D = 3584
    x = torch.randn(32, D, generator=g, device=cuda).bfloat16()
    nw = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).bfloat16()
    packed, scales = _card_w4(D, N, g, cuda)
    b = (torch.randn(N, generator=g, device=cuda).bfloat16() if bias
         else None)
    before = tw.w4_qkv_norm.launches
    out = tw.w4_qkv_norm(x, nw, packed, scales, 1e-6, b)
    torch.cuda.synchronize()
    assert tw.w4_qkv_norm.launches == before + 1
    ref = tw.w4_qkv_norm_reference(x, nw, packed, scales, 1e-6, b)
    assert _rel(out, ref) < 1e-2
    if b is not None:
        plain = tw.w4_qkv_norm(x, nw, packed, scales, 1e-6)
        # the bias moves the result by about its size
        assert _rel(plain + b, out) < 5e-2


def test_res_kernel_at_dream_shape_on_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    K = N = 3584
    a = torch.randn(32, K, generator=g, device=cuda).bfloat16()
    r = torch.randn(32, N, generator=g, device=cuda).bfloat16()
    w = _card_w4(K, N, g, cuda)
    out = tw.w4_matmul_res(a, r, *w)
    torch.cuda.synchronize()
    assert torch.equal(out, tw.w4_matmul_res_reference(a, r, *w))


def test_ffn_kernel_at_dream_shape_on_cuda(cuda):
    """#7 at D 3584, H 18944, the down GEMM reading 20480 padded rows."""
    g = torch.Generator(device=cuda).manual_seed(2)
    D, H, Hd = 3584, 18944, 20480
    nw = (1 + 0.1 * torch.randn(D, generator=g, device=cuda)).bfloat16()
    up = _card_w4(D, 2 * H, g, cuda)
    dn = _card_w4(H, D, g, cuda, Kp=Hd)
    assert dn[0].shape[1] * 128 == Hd
    x = torch.empty(32, D, dtype=torch.bfloat16, device=cuda)
    for _ in range(2):
        x.copy_(torch.randn(32, D, generator=g, device=cuda))
        out = tw.w4_ffn_fused(x, nw, *up, *dn, 1e-6)
        torch.cuda.synchronize()
        assert _rel(out, tw.w4_ffn_fused_reference(x, nw, *up, *dn,
                                                   1e-6)) < 2e-2


@pytest.mark.parametrize("T,K,N", [(1100, 3584, 4608), (77, 384, 1001)])
def test_w8a8_bias_kernel_on_cuda(cuda, T, K, N):
    """#3 with the bias in its epilogue: bit-exact with its plain version
    at the Dream prefill's [q|k|v] and a ragged case."""
    from lavida_mod_tpu_torch.ops import w8a8 as t8

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    q, sc = tq.quantize_linear(torch.randn(N, K, generator=g,
                                           device=cuda) * 0.02)
    b = torch.randn(N, generator=g, device=cuda).bfloat16()
    x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W8)
    out = t8.w8a8_matmul(x8, sx, q, sc, b)
    torch.cuda.synchronize()
    assert torch.equal(out, t8.w8a8_matmul_reference(x8, sx, q, sc, b))
    assert torch.equal(t8.w8a8_matmul(x8, sx, q, sc),
                       t8.w8a8_matmul_reference(x8, sx, q, sc))
