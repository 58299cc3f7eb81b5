"""The MoE block in the port (models/moe.py and the LLaDA block's `moe`)
against the JAX package's (lavida_mod_tpu/models/moe.py) on the CPU,
mirroring tests/test_moe.py:
  - one expert with top-1 is that expert's SwiGLU, its load exactly 1;
  - top-2 over 4 experts: output within 1e-6 of JAX's in f32 (bit-exact
    routing: the same combine weights), the load summing to 1, the
    load-balancing loss JAX's (and at least 1, its minimum at uniform
    load);
  - ties between router probabilities break to the lower expert index,
    as jax.lax.top_k breaks them;
  - in bf16 the dense dispatch (bf16 silu(h) * u, the combine in y's
    dtype) bit-equal to JAX's with XLA's excess precision off
    (tests/torch_jax_strict.py);
  - blocks carrying experts in the LLaDA forward (logits within 1e-5 of
    max |JAX logit| in f32) and in the AR decode (tokens equal in f32;
    bf16 teacher-forced, the logits within 2e-2 of max |JAX logit| and
    the argmax JAX's token but for counted near-ties);
  - the block's moe entry carried by convert.py, stacked or per layer;
    to_fused_layout keeps it; quantize refuses it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import tiny_llada_config
from lavida_mod_tpu.generation.ar_sampler import ar_generate_fused as jar
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import moe as jmoe
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.generation.ar_sampler import ar_generate_fused
from lavida_mod_tpu_torch.models import ar_models as tam
from lavida_mod_tpu_torch.models import moe as tmoe

torch.set_num_threads(2)


def _moe_params(D, H, E, seed, scale=1.0):
    p = jmoe.init_moe_params(D, H, E, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.asarray(a) * scale, p)


def _port(p, dtype=torch.float32):
    ex = p["experts"]
    return [torch.as_tensor(np.asarray(a, np.float32)).to(dtype)
            for a in (p["router"]["kernel"], ex["ff_proj"]["kernel"],
                      ex["up_proj"]["kernel"], ex["ff_out"]["kernel"])]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_single_expert_equals_dense():
    D, H = 16, 32
    p = _moe_params(D, H, 1, 0)
    x = _x((2, 5, D), 0)
    out, load = tmoe.moe_ff(torch.from_numpy(x), *_port(p), top_k=1)
    e = p["experts"]
    xs = torch.from_numpy(x)
    w = [torch.from_numpy(np.asarray(e[k]["kernel"][0]))
         for k in ("ff_proj", "up_proj", "ff_out")]
    ref = (torch.nn.functional.silu(xs @ w[0]) * (xs @ w[1])) @ w[2]
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert abs(float(load[0]) - 1.0) < 1e-6
    jout, _ = jmoe.moe_ff(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                          top_k=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=0)


def test_topk_weights_renormalized_and_loss():
    D, H, E = 8, 16, 4
    p = _moe_params(D, H, E, 1, scale=20.0)
    x = _x((1, 7, D), 1)
    out, load = tmoe.moe_ff(torch.from_numpy(x), *_port(p), top_k=2)
    jout, jload = jmoe.moe_ff(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                              top_k=2)
    assert out.shape == x.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(load.numpy(), np.asarray(jload), atol=1e-7,
                               rtol=0)
    assert abs(float(load.sum()) - 1.0) < 1e-5
    aux = tmoe.load_balancing_loss(load)
    assert float(aux) >= 1.0 - 1e-5
    assert abs(float(aux) - float(jmoe.load_balancing_loss(jload))) < 1e-6
    frac = torch.tensor([0.5, 0.25, 0.25, 0.0])
    assert abs(float(tmoe.load_balancing_loss(load, frac)) - float(
        jmoe.load_balancing_loss(jload, jnp.asarray(frac.numpy())))) < 1e-6


def test_ties_break_to_the_lower_expert():
    """Equal router probabilities: jax.lax.top_k keeps the lower indices
    first, and so does the port's gate."""
    probs = np.array([[[0.25, 0.25, 0.25, 0.25],
                       [0.1, 0.3, 0.3, 0.3],
                       [0.4, 0.1, 0.4, 0.1]]], np.float32)
    got = tmoe.top_k_gate(torch.from_numpy(probs), 2)
    vals, idx = jax.lax.top_k(jnp.asarray(probs), 2)
    vals = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
    want = (jax.nn.one_hot(idx, 4) * vals[..., None]).sum(2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 1, 1] > 0 and got[0, 1, 2] > 0 and got[0, 1, 3] == 0


def test_bf16_dense_dispatch_bit_exact(tmp_path):
    from torch_jax_strict import strict_jax

    D, H, E = 64, 96, 4
    p = _moe_params(D, H, E, 2, scale=10.0)
    pb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                           np.float32), p)
    x = np.asarray(jnp.asarray(_x((2, 9, D), 2), jnp.bfloat16), np.float32)
    ex = pb["experts"]
    ref = strict_jax("""
import jax, jax.numpy as jnp
from lavida_mod_tpu.models.moe import moe_ff
bf = lambda k: jnp.asarray(IN[k], jnp.bfloat16)
p = {"router": {"kernel": bf("router")},
     "experts": {k: {"kernel": bf(k)} for k in ("ff_proj", "up_proj",
                                                "ff_out")}}
out, load = moe_ff(bf("x"), p)
OUT["out"] = np.asarray(out.astype(jnp.float32))
OUT["load"] = np.asarray(load)
""", tmp_path, {"x": x, "router": pb["router"]["kernel"],
                **{k: ex[k]["kernel"] for k in ex}})
    out, load = tmoe.moe_ff(torch.from_numpy(x).bfloat16(),
                            *_port(pb, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref["out"])
    np.testing.assert_allclose(load.numpy(), ref["load"], atol=1e-7, rtol=0)


def _moe_lm(stacked=True, dtype=np.float32):
    """A tiny LLaDA whose blocks' FFs are 4-expert MoEs (test_moe.py's
    model), matrices x3; numpy leaves."""
    cfg = tiny_llada_config()
    p = jl.init_params(cfg, jax.random.PRNGKey(0))
    moes = [jmoe.init_moe_params(cfg.d_model, 32, 4, jax.random.fold_in(
        jax.random.PRNGKey(7), i)) for i in range(cfg.n_layers)]
    p["blocks"]["moe"] = jax.tree.map(lambda *xs: jnp.stack(xs), *moes)
    for k in ("ff_proj", "up_proj", "ff_out"):
        del p["blocks"][k]
    p = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 3 else a, p)
    if not stacked:
        p = jl.unstack_blocks(p)
    return cfg, jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, dtype), np.float32), p)


def _port_lm(cfg, p, dtype=torch.float32):
    sd = state_dict_from_jax({"llada": p})
    return tam.ar_model(cfg, {k[len("llada."):]: v.to(dtype)
                              for k, v in sd.items()}, "cpu")


@pytest.mark.parametrize("stacked", [True, False])
def test_moe_block_in_forward_and_ar_decode(stacked):
    cfg, p = _moe_lm(stacked)
    m = _port_lm(cfg, p)
    assert all(b.moe is not None and not hasattr(b, "up_proj")
               for b in m.blocks)
    assert m.blocks[0].moe.n_experts == 4 and m.blocks[0].moe.hidden == 32
    ids = np.arange(5, 15)[None]
    jp = jax.tree.map(jnp.asarray, p)
    emb = jl.embed_tokens(jp, jnp.asarray(ids))
    jlg, _ = jl.forward(jp, cfg, emb)
    with torch.no_grad():
        tlg, _ = m(m.embed_tokens(torch.as_tensor(ids)))
    jlg = np.asarray(jlg)
    assert np.abs(tlg.numpy() - jlg).max() < 1e-5 * np.abs(jlg).max()
    want = np.asarray(jar(jp, cfg, emb, jax.random.PRNGKey(0), 6, eos_id=-1))
    got = ar_generate_fused(m, m.embed_tokens(torch.as_tensor(ids)), 6,
                            eos_id=-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_ar_decode_bf16_teacher_forced(tmp_path):
    from torch_jax_strict import strict_jax

    cfg, p = _moe_lm(False, jnp.bfloat16)
    G = 8
    ids = np.random.default_rng(4).integers(3, 500, size=(2, 11))
    flat = {}
    for path, a in jax.tree_util.tree_leaves_with_path(p):
        flat["p/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path)] = a
    ref = strict_jax("""
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import tiny_llada_config
from lavida_mod_tpu.generation.ar_sampler import ar_generate_fused
from lavida_mod_tpu.models import llada as jl
tree = {}
for key, a in IN.items():
    if key.startswith("p/"):
        node, parts = tree, key[2:].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = jnp.asarray(a, jnp.bfloat16)
tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
cfg = tiny_llada_config()
G = %d
prefix = jl.embed_tokens(tree, jnp.asarray(IN["ids"]))
toks = ar_generate_fused(tree, cfg, prefix, jax.random.PRNGKey(0), G,
                         eos_id=-1)
lg, cache = jl.forward(tree, cfg, prefix, causal=True, use_cache=True,
                       last_logits_only=True)
pw = ((0, 0), (0, G), (0, 0), (0, 0))
cache = [(jnp.pad(cache["k"][i], pw), jnp.pad(cache["v"][i], pw))
         for i in range(cfg.n_layers)]
logits = [lg[:, -1]]
for i in range(G - 1):
    lg, cache = jl.forward(tree, cfg, jl.embed_tokens(tree, toks[:, i:i + 1]),
                           kv_cache=cache, kv_write_index=IN["ids"].shape[1] + i,
                           use_cache=True, causal=True)
    logits.append(lg[:, -1])
OUT["tokens"] = np.asarray(toks)
OUT["logits"] = np.asarray(jnp.stack(logits, 1), np.float32)
""" % G, tmp_path, {"ids": ids, **flat})
    m = _port_lm(cfg, p, torch.bfloat16)
    prefix = m.embed_tokens(torch.as_tensor(ids))
    jt = torch.as_tensor(ref["tokens"]).long()
    want = torch.as_tensor(ref["logits"])
    Hkv, hd, P = m.kv_heads, cfg.head_dim, ids.shape[1]
    cache = [(prefix.new_zeros(2, P + G, Hkv, hd),
              prefix.new_zeros(2, P + G, Hkv, hd)) for _ in m.blocks]
    with torch.no_grad():
        lg, _ = m(prefix, kv_cache=cache, kv_write_index=0, use_cache=True,
                  last_logits_only=True, causal=True)
        got = [lg[:, -1]]
        for i in range(G - 1):
            lg, _ = m(m.embed_tokens(jt[:, i:i + 1]), kv_cache=cache,
                      kv_write_index=P + i, use_cache=True, causal=True)
            got.append(lg[:, -1])
    got = torch.stack(got, 1)
    assert ((got - want).abs().max() / want.abs().max()).item() < 2e-2
    for b in range(2):
        for t in range(G):
            if int(got[b, t].argmax()) != int(jt[b, t]):
                delta = (got[b, t] - want[b, t]).abs().max().item()
                top2 = torch.topk(want[b, t], 2).values
                assert (top2[0] - top2[1]).item() <= 2 * delta, (b, t)


def test_fused_layout_keeps_experts_and_quantize_refuses():
    cfg, p = _moe_lm(False)
    m = _port_lm(cfg, p)
    ids = torch.arange(5, 15)[None]
    with torch.no_grad():
        before, _ = m(m.embed_tokens(ids), causal=True)
        m.to_fused_layout()
        after, _ = m(m.embed_tokens(ids), causal=True)
    assert all(b.moe is not None and hasattr(b, "att_proj")
               and not hasattr(b, "ff_proj") for b in m.blocks)
    torch.testing.assert_close(after, before, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="MoE"):
        m.quantize(4)


def test_init_moe_params_shapes_equal_jax():
    """init_moe_params draws the JAX init's shapes (router [D, E], the
    stacked [E, in, out] experts) at std 0.02, seeded, in MoE's layout."""
    D, H, E = 16, 24, 3
    jp = jmoe.init_moe_params(D, H, E, jax.random.PRNGKey(0))
    want = {"router": jp["router"]["kernel"].shape,
            **{k: v["kernel"].shape for k, v in jp["experts"].items()}}
    a = tmoe.init_moe_params(D, H, E, torch.Generator().manual_seed(0))
    b = tmoe.init_moe_params(D, H, E, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in a.items()} == want
    assert all(torch.equal(a[k], b[k]) for k in a)
    m = tmoe.MoE(D, H, E, "meta")
    m.load_state_dict(a, assign=True)
    assert (m.n_experts, m.hidden) == (E, H)
    assert abs(torch.cat([v.flatten() for v in a.values()]).std().item()
               - 0.02) < 0.004
