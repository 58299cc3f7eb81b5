"""The AR baselines in the port (models/ar_models.py, generation/
ar_sampler.py, the LLaDA forward's causal mode and the options of
models/llada.py that the JAX forward runs) against the JAX package on the
CPU.

Held here, at tiny widths (2 layers, d_model 256, GQA 4 / 2, vocab 512,
the JAX init's matrices x3 so the logits spread):
  - the four configs equal JAX's, with and without overrides;
  - the causal mask: a later token leaves earlier logits alone, and the
    causal forward's logits within 1e-5 of max |JAX logit| in f32;
  - `ar_generate_fused` at temperature 0 in f32, bf16 and the int4 fused
    layout (bench.py --ar's), and for every new LLaDA option in bf16 and
    int4: the JAX side runs in a child with XLA's excess precision off
    (tests/torch_jax_strict.py).  Teacher-forced: the port's causal
    prefill and kv_write_index decode from the tokens of JAX's (jitted)
    ar_generate_fused, each step's logits within the case's band of max
    |JAX logit| of JAX's op-by-op steps (f32 1e-5; bf16 and int4 2e-2, the
    rounding of the matrix products' summation order) and its argmax
    JAX's token but for counted near-ties: a top-2 gap within 2 x the
    step's largest logit difference, the port's from JAX op by op or
    JAX's own jitted steps' (XLA rewrites the int4 CPU path's / 127 into
    * (1 / 127) under jit; the port divides, as op-by-op JAX does);
    free-running, the port's tokens equal JAX's up to the first near-tie;
  - a cached decode equal to a full causal recompute in the port;
  - EOS: a finished row keeps emitting eos, as JAX's;
  - temperature 0.7 / top-k 20 with JAX's own Gumbel draws from its key
    chain injected (f32): token for token;
  - the HF converters (Llama, Qwen2 with the QKV bias, Mistral, a Mixtral
    layer and a whole Mixtral state dict) on seeded HF-named state dicts
    against JAX's converters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import tiny_llada_config
from lavida_mod_tpu.generation.ar_sampler import ar_generate_fused as jar
from lavida_mod_tpu.models import ar_models as jam
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu_torch.config import as_port_config
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.generation.ar_sampler import ar_generate_fused
from lavida_mod_tpu_torch.models import ar_models as tam
from lavida_mod_tpu_torch.models.llada import LLaDA

torch.set_num_threads(2)

B, P, G = 2, 13, 8
BANDS = {"f32": 1e-5, "bf16": 2e-2, "int4": 2e-2}
# the new LLaDA options (llada.py:269-274, :280, :479-480, :709-710,
# norms.py:44-55, the activations of llada.py:112-125), one case each
OPTIONS = {
    "ln_default": dict(layer_norm_type="default"),
    "ln_low_precision": dict(layer_norm_type="low_precision"),
    "gemma_rms": dict(layer_norm_type="gemma_rms"),
    "no_rope": dict(rope=False),
    "attention_layer_norm": dict(attention_layer_norm=True),
    "input_emb_norm": dict(input_emb_norm=True),
    "scale_logits": dict(scale_logits=True),
    "sequential_gelu": dict(block_type="sequential", activation="gelu"),
    "relu": dict(activation="relu"),
}


def lm_cfg(**kw):
    base = dict(d_model=256, n_heads=4, n_kv_heads=2, mlp_hidden_size=512)
    base.update(kw)
    return tiny_llada_config(**base)


def _params(cfg, seed=0):
    """JAX init_params, matrices x3, unstacked, numpy f32 leaves."""
    p = jl.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    p = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 3 else a, p)
    return jax.tree.map(np.asarray, jl.unstack_blocks(p))


def _flat(tree):
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out["p/" + key] = np.asarray(a, np.float32)
    return out


def port_lm(cfg, params, dtype=torch.float32):
    """The port's LLaDA with a JAX LM params tree (numpy leaves)."""
    sd = state_dict_from_jax({"llada": params})
    sd = {k[len("llada."):]: v.to(dtype) for k, v in sd.items()}
    return tam.ar_model(cfg, sd, "cpu")


def _layout(m, mode):
    """The port model in a case's layout: bf16 / int4 (fused when the
    block allows it, as bench.py --ar)."""
    if mode == "int4":
        if m.cfg.block_type == "llama" and m.cfg.activation == "silu":
            m.to_fused_layout()
        m.quantize(4)
    return m


def prefix_ids(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 500, size=(B, P))


# the JAX side, in the strict child: per case, the jitted ar_generate_fused
# tokens and the teacher-forced logits of every step (prefill and decode
# steps jitted)
CHILD = """
import jax, jax.numpy as jnp, numpy as np
from lavida_mod_tpu.config import tiny_llada_config
from lavida_mod_tpu.generation.ar_sampler import ar_generate_fused
from lavida_mod_tpu.models import llada as jl

def unflatten(prefix, dtype):
    tree = {}
    for key, a in IN.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = jnp.asarray(a, dtype)
    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(tree)

def run(tag, cfg, params, ids, mode, G):
    dt = jnp.float32 if mode == "f32" else jnp.bfloat16
    if mode == "int4":
        if cfg.block_type == "llama" and cfg.activation == "silu":
            params, cfg = jl.to_fused_layout(params, cfg)
        params = jl.quantize_params(params, bits=4)
    prefix = jl.embed_tokens(params, ids).astype(dt)
    toks = ar_generate_fused(params, cfg, prefix, jax.random.PRNGKey(0), G,
                             eos_id=-1)
    OUT[tag + "/tokens"] = np.asarray(toks)
    # op by op, and jitted as ar_generate_fused is (XLA then rewrites, e.g.,
    # the int4 CPU path's / 127 into * (1 / 127))
    for name, wrap in (("logits", lambda f: f), ("jit_logits", jax.jit)):
        pre = wrap(lambda p, x: jl.forward(p, cfg, x, causal=True,
                                           use_cache=True,
                                           last_logits_only=True))
        dec = wrap(lambda p, e, c, w: jl.forward(
            p, cfg, e, kv_cache=c, kv_write_index=w, use_cache=True,
            causal=True))
        lg, cache = pre(params, prefix)
        pw = ((0, 0), (0, G), (0, 0), (0, 0))
        cache = [(jnp.pad(cache["k"][i], pw), jnp.pad(cache["v"][i], pw))
                 for i in range(cache["k"].shape[0])]
        logits = [lg[:, -1]]
        Pn = ids.shape[1]
        for i in range(G - 1):
            emb = jl.embed_tokens(params, toks[:, i:i + 1])
            lg, cache = dec(params, emb, cache, jnp.int32(Pn + i))
            logits.append(lg[:, -1])
        OUT[tag + "/" + name] = np.asarray(jnp.stack(logits, 1), np.float32)
"""


def _cases():
    cases = [("base_f32", {}, "f32"), ("base_bf16", {}, "bf16"),
             ("base_int4", {}, "int4")]
    for name, kw in OPTIONS.items():
        cases += [(f"{name}_bf16", kw, "bf16"), (f"{name}_int4", kw, "int4")]
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    from torch_jax_strict import strict_jax

    inputs, code = {"ids": prefix_ids()}, CHILD
    for tag, kw, mode in CASES:
        dt = np.float32 if mode == "f32" else jnp.bfloat16
        p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dt),
                                              np.float32),
                         _params(lm_cfg(**kw)))
        inputs.update({f"{tag}/{k}": v for k, v in _flat(p).items()})
        code += (f"run({tag!r}, tiny_llada_config(**{dict(lm_cfg(**kw).__dict__)!r}),"
                 f" unflatten({tag + '/p/'!r}, "
                 f"{'jnp.float32' if mode == 'f32' else 'jnp.bfloat16'}), "
                 f"jnp.asarray(IN['ids']), {mode!r}, {G})\n")
    return strict_jax(code, tmp_path_factory.mktemp("ar"), inputs,
                      timeout=900)


def teacher_forced(m, prefix, tokens):
    """The port's causal prefill into [B, P + G] buffers and one
    kv_write_index decode step per JAX token: the logits each step draws
    from [B, G, V]."""
    Bn, Pn, _ = prefix.shape
    Gn = tokens.shape[1]
    Hkv, hd = m.kv_heads, m.cfg.head_dim
    cache = [(prefix.new_zeros(Bn, Pn + Gn, Hkv, hd),
              prefix.new_zeros(Bn, Pn + Gn, Hkv, hd)) for _ in m.blocks]
    with torch.no_grad():
        lg, _ = m(prefix, kv_cache=cache, kv_write_index=0, use_cache=True,
                  last_logits_only=True, causal=True)
        out = [lg[:, -1]]
        for i in range(Gn - 1):
            lg, _ = m(m.embed_tokens(tokens[:, i:i + 1]), kv_cache=cache,
                      kv_write_index=Pn + i, use_cache=True, causal=True)
            out.append(lg[:, -1])
    return torch.stack(out, 1)


@pytest.mark.parametrize("tag,kw,mode", CASES, ids=[c[0] for c in CASES])
def test_ar_decode_matches_jax(jax_runs, tag, kw, mode):
    cfg = lm_cfg(**kw)
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    p = _params(cfg)
    if mode != "f32":
        p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                              np.float32), p)
    m = _layout(port_lm(cfg, p, dtype), mode)
    ids = torch.as_tensor(prefix_ids())
    prefix = m.embed_tokens(ids)
    jt = torch.as_tensor(jax_runs[tag + "/tokens"]).long()
    ref = torch.as_tensor(jax_runs[tag + "/logits"])
    jit = torch.as_tensor(jax_runs[tag + "/jit_logits"])
    got = teacher_forced(m, prefix, jt)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel < BANDS[mode], (tag, rel)
    ties = []
    for b in range(B):
        for t in range(G):
            if int(got[b, t].argmax()) == int(jt[b, t]):
                continue
            # the port's distance from JAX op by op, or JAX jitted's
            delta = max((got[b, t] - ref[b, t]).abs().max().item(),
                        (jit[b, t] - ref[b, t]).abs().max().item())
            top2 = torch.topk(ref[b, t], 2).values
            assert (top2[0] - top2[1]).item() <= 2 * delta, (tag, b, t)
            ties.append((b, t))
    free = ar_generate_fused(m, prefix, G, eos_id=-1)
    for b in range(B):
        stop = min([t for bb, t in ties if bb == b], default=G)
        assert torch.equal(free[b, :stop], jt[b, :stop]), (tag, b, ties)
    if mode == "f32":
        assert not ties


def test_configs_equal_jax():
    for name in ("llama3_8b_config", "qwen2_7b_config", "mistral_7b_config",
                 "mixtral_8x7b_config"):
        jf, tf = getattr(jam, name), getattr(tam, name)
        assert as_port_config(jf()) == tf(), name
        kw = dict(n_layers=4, max_sequence_length=1024)
        assert as_port_config(jf(**kw)) == tf(**kw), name


def test_causal_mask_blocks_future():
    """A later token moves no earlier logit under causal=True, and does
    without it (test_ar.py's check, on the port); the causal logits are
    JAX's in f32."""
    cfg = lm_cfg()
    p = _params(cfg)
    m = port_lm(cfg, p)
    ids1 = torch.arange(5, 15)[None]
    ids2 = ids1.clone()
    ids2[0, -1] = 499
    with torch.no_grad():
        for causal, same in ((True, True), (False, False)):
            l1, _ = m(m.embed_tokens(ids1), causal=causal)
            l2, _ = m(m.embed_tokens(ids2), causal=causal)
            assert torch.allclose(l1[0, :5], l2[0, :5], atol=1e-6) == same
        tl, _ = m(m.embed_tokens(ids1), causal=True)
    jlg, _ = jl.forward(jax.tree.map(jnp.asarray, p), cfg,
                        jl.embed_tokens(p, jnp.asarray(ids1.numpy())),
                        causal=True)
    jlg = np.asarray(jlg)
    assert np.abs(tl.numpy() - jlg).max() < 1e-5 * np.abs(jlg).max()


def test_causal_refuses_the_flash_paths():
    m = LLaDA(lm_cfg(), "cpu")
    x = torch.zeros(1, 4, 256)
    for kw in (dict(use_flash=True), dict(attention_impl="blockwise"),
               dict(attention_impl="prefix_flash")):
        with pytest.raises(ValueError, match="causal"):
            m(x, causal=True, **kw)


def test_cached_decode_equals_full_recompute():
    """test_ar.py::test_ar_fused_matches_full_recompute on the port: the
    greedy cached decode equals argmax of a full causal forward over
    [prompt, generated] recomputed each step, and its logits those
    rows'."""
    cfg = lm_cfg()
    m = port_lm(cfg, _params(cfg))
    ids = torch.as_tensor(prefix_ids())[:1]
    out, logits = ar_generate_fused(m, m.embed_tokens(ids), G, eos_id=-1,
                                    return_logits=True)
    seq = ids
    with torch.no_grad():
        for t in range(G):
            full, _ = m(m.embed_tokens(seq), causal=True)
            assert torch.allclose(full[0, -1], logits[0, t], atol=1e-4,
                                  rtol=0)
            nxt = full[:, -1].argmax(-1)
            assert int(nxt) == int(out[0, t])
            seq = torch.cat([seq, nxt[:, None]], 1)


def test_eos_rows_keep_emitting_eos():
    """A row that emitted eos keeps emitting eos while the other goes on
    (ar_sampler.py:80-82), as JAX's ar_generate_fused does."""
    cfg = lm_cfg()
    p = _params(cfg)
    m = port_lm(cfg, p)
    ids = prefix_ids()
    prefix = m.embed_tokens(torch.as_tensor(ids))
    free = ar_generate_fused(m, prefix, G, eos_id=-1)
    eos = int(free[0, 2])
    assert eos not in free[1, :3].tolist()
    got = ar_generate_fused(m, prefix, G, eos_id=eos).numpy()
    want = np.asarray(jar(jax.tree.map(jnp.asarray, p), cfg,
                          jl.embed_tokens(p, jnp.asarray(ids)),
                          jax.random.PRNGKey(0), G, eos_id=eos))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all() and (got[0, :2] != eos).all()
    first = ar_generate_fused(m, prefix, G, eos_id=int(free[0, 0])).numpy()
    assert (first[0] == int(free[0, 0])).all()


def test_temperature_top_k_with_jax_draws():
    """Temperature 0.7, top-k 20: JAX's Gumbel draws of its key chain (the
    first token from the key, step i from split(key)[1]) injected into the
    port give JAX's tokens, token for token."""
    cfg = lm_cfg()
    p = _params(cfg)
    jp = jax.tree.map(jnp.asarray, p)
    ids = prefix_ids()
    jprefix = jl.embed_tokens(p, jnp.asarray(ids))
    key = jax.random.PRNGKey(3)
    V = cfg.vocab_size
    draws = [jax.random.gumbel(key, (B, V), jnp.float32)]
    k = key
    for _ in range(G - 1):
        k, sk = jax.random.split(k)
        draws.append(jax.random.gumbel(sk, (B, V), jnp.float32))
    want = np.asarray(jar(jp, cfg, jprefix, key, G, temperature=0.7,
                          top_k=20, eos_id=-1))
    m = port_lm(cfg, p)
    got = ar_generate_fused(m, m.embed_tokens(torch.as_tensor(ids)), G,
                            temperature=0.7, top_k=20, eos_id=-1,
                            gumbel=torch.as_tensor(np.stack(draws)))
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = ar_generate_fused(m, m.embed_tokens(torch.as_tensor(ids)), G,
                               eos_id=-1)
    assert not torch.equal(got, greedy)
    # drawn from a generator, the tokens are below the vocab and seeded
    a = ar_generate_fused(m, m.embed_tokens(torch.as_tensor(ids)), G,
                          temperature=1.0, top_k=50,
                          generator=torch.Generator().manual_seed(1))
    b = ar_generate_fused(m, m.embed_tokens(torch.as_tensor(ids)), G,
                          temperature=1.0, top_k=50,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and int(a.max()) < V


def _hf_state(cfg, seed, moe=False, n_experts=4, bias=False):
    """A seeded HF (Llama / Qwen2 / Mixtral) state dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    D, H, L = cfg.d_model, cfg.hidden_size, cfg.n_layers
    kvD = cfg.effective_n_kv_heads * cfg.head_dim
    V = cfg.vocab_size

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    s = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
         "lm_head.weight": w(V, D)}
    for i in range(L):
        pre = f"model.layers.{i}."
        for n, o in (("q_proj", D), ("k_proj", kvD), ("v_proj", kvD),
                     ("o_proj", D)):
            s[f"{pre}self_attn.{n}.weight"] = w(o, D)
            if bias and n != "o_proj":
                s[f"{pre}self_attn.{n}.bias"] = w(o)
        s[pre + "input_layernorm.weight"] = 1 + w(D)
        s[pre + "post_attention_layernorm.weight"] = 1 + w(D)
        if moe:
            s[pre + "block_sparse_moe.gate.weight"] = w(n_experts, D)
            for e in range(n_experts):
                for n, shape in (("w1", (H, D)), ("w3", (H, D)),
                                 ("w2", (D, H))):
                    s[f"{pre}block_sparse_moe.experts.{e}.{n}.weight"] = \
                        w(*shape)
        else:
            for n, shape in (("gate_proj", (H, D)), ("up_proj", (H, D)),
                             ("down_proj", (D, H))):
                s[f"{pre}mlp.{n}.weight"] = w(*shape)
    return s


@pytest.mark.parametrize("family", ["llama3", "qwen2", "mistral"])
def test_hf_converter_matches_jax(family):
    """convert_ar_state_dict (Dream's names) gives the module JAX's
    converter gives: state dicts equal, logits equal."""
    cfgs = {"llama3": jam.llama3_8b_config, "qwen2": jam.qwen2_7b_config,
            "mistral": jam.mistral_7b_config}
    cfg = cfgs[family](d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                       mlp_hidden_size=128, vocab_size=300,
                       embedding_size=300, max_sequence_length=256)
    state = _hf_state(cfg, 5, bias=cfg.include_qkv_bias)
    jp = jam.convert_ar_state_dict(state, cfg, dtype=jnp.float32)
    want = state_dict_from_jax({"llada": jax.tree.map(np.asarray, jp)})
    got = tam.convert_ar_state_dict(state, cfg, dtype=torch.float32)
    assert set(got) == {k[len("llada."):] for k in want}
    for k, v in got.items():
        assert torch.equal(v, want["llada." + k]), k
    m = tam.ar_model(cfg, got, "cpu")
    ids = np.arange(3, 12)[None]
    jlg, _ = jl.forward(jp, cfg, jl.embed_tokens(jp, jnp.asarray(ids)),
                        causal=True)
    with torch.no_grad():
        tlg, _ = m(m.embed_tokens(torch.as_tensor(ids)), causal=True)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-5,
                               rtol=0)


def test_mixtral_converters_match_jax():
    """convert_mixtral_moe_layer on numpy and on torch inputs equals JAX's
    leaf for leaf; a whole Mixtral state dict converts to the module whose
    causal logits are JAX's (JAX's blocks: the dense converter's attention
    and JAX's moe layers)."""
    cfg = jam.mixtral_8x7b_config(d_model=64, n_heads=4, n_kv_heads=2,
                                  n_layers=2, mlp_hidden_size=96,
                                  vocab_size=300, embedding_size=300,
                                  max_sequence_length=256)
    state = _hf_state(cfg, 7, moe=True)
    for src in (state, {k: torch.from_numpy(v) for k, v in state.items()}):
        for i in range(cfg.n_layers):
            want = jam.convert_mixtral_moe_layer(state, i, 4,
                                                 dtype=jnp.float32)
            got = tam.convert_mixtral_moe_layer(src, i, 4,
                                                dtype=torch.float32)
            np.testing.assert_array_equal(got["router"].numpy(),
                                          np.asarray(want["router"]["kernel"]))
            for k in ("ff_proj", "up_proj", "ff_out"):
                np.testing.assert_array_equal(
                    got[k].numpy(), np.asarray(want["experts"][k]["kernel"]))
    dense = dict(state)
    for i in range(cfg.n_layers):
        for n, shape in (("gate_proj", (96, 64)), ("up_proj", (96, 64)),
                         ("down_proj", (64, 96))):
            dense[f"model.layers.{i}.mlp.{n}.weight"] = np.zeros(shape,
                                                                 np.float32)
    jp = jl.unstack_blocks(jam.convert_ar_state_dict(
        {k: v for k, v in dense.items() if "block_sparse" not in k}, cfg,
        dtype=jnp.float32))
    for i, b in enumerate(jp["blocks"]):
        for k in ("ff_proj", "up_proj", "ff_out"):
            del b[k]
        b["moe"] = jam.convert_mixtral_moe_layer(state, i, 4,
                                                 dtype=jnp.float32)
    m = tam.ar_model(cfg, tam.convert_ar_state_dict(state, cfg,
                                                    torch.float32), "cpu")
    assert all(b.moe is not None and b.moe.n_experts == 4 for b in m.blocks)
    ids = np.arange(3, 12)[None]
    jlg, _ = jl.forward(jp, cfg, jl.embed_tokens(jp, jnp.asarray(ids)),
                        causal=True)
    with torch.no_grad():
        tlg, _ = m(m.embed_tokens(torch.as_tensor(ids)), causal=True)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-5,
                               rtol=0)


def test_int4_ar_layout_runs_the_grouped_linears():
    """bench.py --ar's layout at B = 1: the fused [q|k|v] / [up|gate]
    linears in int4, MHA (Vicuna's n_kv_heads = n_heads), every linear an
    Int4Linear whose 1-row decode declines the fused plan, the ff_out K
    and the head's N padded as quantize_linear4 pads them."""
    from lavida_mod_tpu_torch.ops.quant import Int4Linear

    cfg = lm_cfg(n_kv_heads=4, mlp_hidden_size=344, vocab_size=500,
                 embedding_size=500)
    m = port_lm(cfg, _params(cfg), torch.bfloat16)
    m.to_fused_layout()
    m.quantize(4)
    blk = m.blocks[0]
    assert isinstance(blk.att_proj, Int4Linear)
    assert blk.att_proj.out_features == 3 * 256
    assert blk.ff_proj.out_features == 2 * 344
    assert blk.ff_out.in_features == 344 and m.ff_out.padded
    assert not blk.fused_plan(1, False) and not m.head_fusable(1)
    out = ar_generate_fused(m, m.embed_tokens(torch.as_tensor(
        prefix_ids())[:1]), 4)
    assert out.shape == (1, 4) and int(out.max()) < 500


def test_loader_reads_q_and_k_norms():
    """The reference LLaDA loader maps blocks.<i>.{q,k}_norm.weight, as
    JAX's llada_loader reads them (llada_loader.py:28), onto the block's
    q_norm / k_norm; a model with attention_layer_norm loads them."""
    from lavida_mod_tpu_torch.models import llada_loader as tl

    cfg = lm_cfg(attention_layer_norm=True)
    for n in ("q_norm", "k_norm"):
        assert tl.port_name(f"blocks.1.{n}.weight", cfg) == \
            f"blocks.1.{n}.weight"
    m = LLaDA(cfg, "meta")
    names = dict(m.named_parameters())
    assert names["blocks.0.q_norm.weight"].shape == (256,)
    assert names["blocks.0.k_norm.weight"].shape == (128,)
    state = {f"model.transformer.{k}": 0 for k in names}
    assert set(tl.lm_plan(state, cfg)) == set(names)
