"""The other branches of the port's `generate` against the JAX package on
the CPU: the two cache modes of `LLaDA.forward` they need, generation
without the prefix cache, the dLLM partial-recompute cache, the verbose
history, draft tokens, the refusals, and the entry points.

  - Cache modes (tiny_llada_config, weights x10, f32): the concat mode
    (a read-only unpadded prefix cache, this call's keys appended, padded
    rows masked) and the scatter mode (K/V written at given cache rows,
    explicit positions, the caller's mask) give JAX's logits and caches
    within 1e-5 of max |value|; a cached decode equals one full forward
    over [prefix, gen] with the prefix-LM mask, gen rows only (the
    oracle of the repo's verify notes); a quantized cache takes neither
    mode.
  - Generation in f32 at temperature 0 with low_confidence remasking
    (the JAX side with its prefill through the Pallas kernel in interpret
    mode, as the port prefills through its kernel's plain version):
    token-exact with JAX for no cache (B = 1 and a front-padded B = 3),
    draft tokens (cached and no cache), verbose (cached and no cache,
    every snapshot), dLLM (r = G, r > G, r < G, several blocks, a
    front-padded prefix), and a
    dLLM case whose re-forwarded rows are decided by ties of the
    priority, which `dllm_rows` breaks as jax.lax.top_k does.
  - bf16 and the grouped-int4 layout (tests/torch_jax_strict.py's child,
    excess precision off): the no-cache denoise and the dLLM steps
    teacher-forced from JAX's recorded states, logits within 5 % of max
    |logit| and commits equal but for counted near-ties.
  - The refusals raise NotImplementedError with JAX's messages.
  - `predict --no-prefix-cache` and `predict_fim` run without jax; a tiny
    CPU worker answers `{"prefix_lm": false}` requests (alone, and two
    merged into one batch) as the eval model does.
  - On a card (`-k cuda`): each step of the tiny no-cache, dLLM,
    verbose and draft routes run from the CPU's state (chip_smoke's
    `tiny_route_steps`, also run here with a second CPU copy in the
    card's place), then each whole route on the card.
"""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (GenerationConfig, LaViDaConfig,
                                   VisionConfig, tiny_llada_config,
                                   tiny_siglip_config)
from lavida_mod_tpu.data.anyres import anyres_grid_shape
from lavida_mod_tpu.generation import diffusion as jd
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.generation import diffusion as td
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.models.llada import LLaDA
import chip_smoke
from torch_jax_strict import strict_jax, teacher_forced

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
LCFG = tiny_llada_config()
MASK = LCFG.mask_token_id
TOL = 1e-5


def _make_pair(scale):
    p = jl.unstack_blocks(jax.tree.map(lambda a: a * scale if a.ndim >= 2
                                       else a,
                                       jl.init_params(LCFG,
                                                      jax.random.PRNGKey(0))))
    m = LLaDA(LCFG, "cpu")
    sd = state_dict_from_jax({"llada": jax.tree.map(np.asarray, p)})
    m.load_state_dict({k[len("llada."):]: v for k, v in sd.items()})
    return p, m


@pytest.fixture(scope="module")
def pair():
    """(JAX params, unstacked blocks, x10 so the tiny model's tokens vary;
    the port LLaDA with them)."""
    return _make_pair(10.0)


@pytest.fixture(scope="module")
def pair1():
    """The same at JAX's init scale, where f32 logits of the two packages
    agree to ~3e-7 of their largest (at x10 their plain forwards already
    differ by ~2e-5), for the 1e-5 comparisons of the cache modes."""
    return _make_pair(1.0)


def _prefix(B, P, seed=0, scale=10.0):
    """Embeddings of seeded prompt ids (the model's own wte rows)."""
    p = jl.init_params(LCFG, jax.random.PRNGKey(0))
    ids = np.random.default_rng(seed).integers(3, 400, (B, P))
    x = np.asarray(jl.embed_tokens(p, jnp.asarray(ids))) * scale
    return jnp.asarray(x), torch.from_numpy(x)


def _valid(B, P, pads):
    v = np.ones((B, P), bool)
    for b, n in enumerate(pads):
        v[b, :n] = False
    return jnp.asarray(v), torch.from_numpy(v)


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# the cache modes of LLaDA.forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pads", [None, (0, 5)])
def test_concat_mode_matches_jax(pair1, pads):
    p, m = pair1
    B, P, G = (1 if pads is None else 2), 12, 8
    jpre, tpre = _prefix(B, P, scale=1.0)
    jv = tv = None
    if pads is not None:
        jv, tv = _valid(B, P, pads)
    _, jcache = jl.forward(p, LCFG, jpre, self_valid=jv, use_cache=True,
                           return_logits=False, use_flash=True)
    for li, (k, v) in enumerate(td.prefill(m, tpre, tv)):
        assert _rel(k, jcache["k"][li]) < TOL and \
            _rel(v, jcache["v"][li]) < TOL
    # the decode over the same cache
    tcache = [(torch.from_numpy(np.array(jcache["k"][li])),
               torch.from_numpy(np.array(jcache["v"][li])))
              for li in range(LCFG.n_layers)]
    ids = np.random.default_rng(1).integers(3, 400, (B, G))
    jl_, jnew = jl.forward(p, LCFG, jl.embed_tokens(p, jnp.asarray(ids)),
                           positions=jnp.arange(P, P + G), kv_cache=jcache,
                           kv_valid=jv, use_cache=True)
    with torch.no_grad():
        tl, tnew = m(m.embed_tokens(torch.from_numpy(ids)),
                     positions=torch.arange(P, P + G), kv_cache=tcache,
                     kv_valid=tv, use_cache=True)
        tdefault, _ = m(m.embed_tokens(torch.from_numpy(ids)),
                        kv_cache=tcache, kv_valid=tv)
    assert _rel(tl, jl_) < TOL
    assert torch.equal(tl, tdefault)        # positions default to P..
    # the present is this call's K/V alone, as JAX returns it
    assert tnew[0][0].shape == (B, G, LCFG.effective_n_kv_heads,
                                LCFG.head_dim)
    assert _rel(tnew[1][0], jnew["k"][1]) < TOL


@pytest.mark.parametrize("with_valid", [False, True])
def test_scatter_mode_matches_jax(pair1, with_valid):
    p, m = pair1
    P, G, T = 10, 8, 3
    jpre, tpre = _prefix(1, P, seed=2, scale=1.0)
    _, jc = jl.forward(p, LCFG, jpre, use_cache=True, return_logits=False)
    pad = ((0, 0), (0, 0), (0, G), (0, 0), (0, 0))
    jk, jvv = jnp.pad(jc["k"], pad), jnp.pad(jc["v"], pad)
    ids = np.random.default_rng(3).integers(3, 400, (1, G))
    kvv = None
    if with_valid:
        kvv = np.ones((1, P + G), bool)
        kvv[0, 2:4] = False
    jcache = [(jk[i], jvv[i]) for i in range(LCFG.n_layers)]
    jkvv = None if kvv is None else jnp.asarray(kvv)
    # seed the gen rows, then re-forward T of them at scattered rows
    _, jcache = jl.forward(p, LCFG, jl.embed_tokens(p, jnp.asarray(ids)),
                           kv_cache=jcache, kv_write_index=jnp.int32(P),
                           kv_valid=jkvv, use_cache=True)
    tcache = [(torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v)))
              for k, v in jcache]
    pos = np.array([6, 1, 4])
    sub = np.random.default_rng(4).integers(3, 400, (1, T))
    jlog, jnew = jl.forward(p, LCFG, jl.embed_tokens(p, jnp.asarray(sub)),
                            positions=jnp.asarray(P + pos),
                            kv_cache=jcache, kv_valid=jkvv,
                            kv_scatter_idx=jnp.asarray(P + pos),
                            use_cache=True)
    tpos = torch.from_numpy(P + pos)
    with torch.no_grad():
        tlog, tnew = m(m.embed_tokens(torch.from_numpy(sub)),
                       positions=tpos, kv_cache=tcache,
                       kv_valid=None if kvv is None
                       else torch.from_numpy(kvv),
                       kv_scatter_idx=tpos, use_cache=True)
    assert _rel(tlog, jlog) < TOL
    for (tk, tv_), (jk_, jv_), (ck, _) in zip(tnew, jnew, tcache):
        assert tk is ck                      # written in place
        assert _rel(tk, jk_) < TOL and _rel(tv_, jv_) < TOL
    with pytest.raises(ValueError, match="explicit"):
        m(m.embed_tokens(torch.from_numpy(sub)), kv_cache=tcache,
          kv_scatter_idx=tpos)


def test_cached_decode_is_the_prefix_lm_forward(pair1):
    """The oracle: decoding over the prefix cache (concat and write-index
    modes) equals one full forward over [prefix, gen] with the prefix-LM
    mask, gen rows only."""
    _, m = pair1
    P, G = 12, 8
    _, tpre = _prefix(1, P, seed=5, scale=1.0)
    ids = torch.from_numpy(np.random.default_rng(6).integers(3, 400, (1, G)))
    with torch.no_grad():
        full, _ = m(torch.cat([tpre, m.embed_tokens(ids)], dim=1),
                    prefix_lengths=torch.tensor([P]))
        concat, _ = m(m.embed_tokens(ids),
                      kv_cache=td.prefill(m, tpre))
        pre = td.prefill_cache(m, tpre, G)
        write, _ = m(m.embed_tokens(ids), kv_cache=pre, kv_write_index=P)
    for got in (concat, write):
        assert _rel(got, full[:, P:]) < TOL


def test_quantized_cache_takes_neither_mode(pair):
    _, m = pair
    P, G = 8, 8
    _, tpre = _prefix(1, P, seed=7)
    cache = td.prefill_cache(m, tpre, G, kv8=True)
    x = m.embed_tokens(torch.full((1, 2), MASK))
    with pytest.raises(ValueError, match="decode cache"):
        m(x, kv_cache=cache)
    with pytest.raises(ValueError, match="decode cache"):
        m(x, positions=torch.tensor([P, P + 1]), kv_cache=cache,
          kv_scatter_idx=torch.tensor([P, P + 1]))


# ---------------------------------------------------------------------------
# generation, token-exact in f32
# ---------------------------------------------------------------------------

# name: (B, front pads, gen kwargs, generate kwargs)
CASES = {
    "nocache_b1": (1, None, dict(prefix_lm=False), {}),
    "nocache_b3_padded": (3, (0, 4, 7), dict(prefix_lm=False), {}),
    "draft_cached": (1, None, {}, dict(draft=True)),
    "draft_nocache": (2, (0, 3), dict(prefix_lm=False), dict(draft=True)),
    "dllm_r_eq_g": (1, None, dict(block_length=16), dict(dllm_cache=16)),
    "dllm_r_over_g": (1, None, dict(block_length=16), dict(dllm_cache=64)),
    "dllm_partial": (1, None, dict(block_length=16), dict(dllm_cache=8)),
    "dllm_multiblock": (1, None, {}, dict(dllm_cache=6)),
    "dllm_padded": (1, (3,), dict(block_length=16), dict(dllm_cache=8)),
}


def _draft(B, seed=8):
    d = np.random.default_rng(seed).integers(3, 400, (B, 6))
    d[:, [1, 4]] = MASK
    return d


def _run_case(pair, name):
    p, m = pair
    B, pads, gkw, kw = CASES[name]
    gen = GenerationConfig(**{**dict(max_new_tokens=16, block_length=8,
                                     steps=8, prefix_lm=True,
                                     schedule="shift", schedule_shift=0.33),
                              **gkw})
    jpre, tpre = _prefix(B, 12, seed=9)
    jv = tv = None
    if pads is not None:
        jv, tv = _valid(B, 12, pads)
    kw = dict(kw)
    draft = _draft(B) if kw.pop("draft", False) else None
    ref = np.asarray(jd.generate(
        p, LCFG, jpre, gen, prefix_valid=jv, use_flash_prefill=True,
        draft_tokens=None if draft is None else jnp.asarray(draft), **kw))
    got = td.generate(m, tpre, gen, prefix_valid=tv, draft_tokens=draft,
                      **kw).numpy()
    return ref, got, draft


@pytest.mark.parametrize("name", list(CASES))
def test_generate_token_exact(pair, name):
    ref, got, draft = _run_case(pair, name)
    np.testing.assert_array_equal(got, ref)
    assert len(set(ref.ravel().tolist())) >= 4, "degenerate tokens"
    if draft is not None:
        keep = draft != MASK
        assert (got[:, :draft.shape[1]][keep] == draft[keep]).all()
    assert (got != MASK).all()


@pytest.mark.parametrize("prefix_lm", [True, False])
def test_verbose_history_every_snapshot(pair, prefix_lm):
    p, m = pair
    gen = GenerationConfig(max_new_tokens=16, block_length=8, steps=8,
                           prefix_lm=prefix_lm)
    jpre, tpre = _prefix(2, 12, seed=10)
    jv, tv = _valid(2, 12, (0, 2))
    rx, rh = jd.generate(p, LCFG, jpre, gen, prefix_valid=jv, verbose=True,
                         use_flash_prefill=True)
    tx, th = td.generate(m, tpre, gen, prefix_valid=tv, verbose=True)
    assert len(th) == len(rh) == 8
    for a, b in zip(th, rh):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(th[-1], tx.numpy())
    masks = [int((h == MASK).sum()) for h in th]
    assert masks == sorted(masks, reverse=True) and masks[-1] == 0
    # no step: the buffer and no history
    empty = gen.replace(max_new_tokens=8, block_length=8)
    full = np.full((2, 8), 5)
    x, h = td.generate(m, tpre, empty, prefix_valid=tv, verbose=True,
                       draft_tokens=full)
    assert h == [] and (x.numpy() == 5).all()


def test_dllm_rows_break_ties_as_jax_top_k():
    rng = np.random.default_rng(11)
    for _ in range(50):
        G = int(rng.integers(4, 40))
        prio = rng.choice([-1e6, 0.0, 1.0, 2.0, 1e6], G).astype(np.float32)
        r = int(rng.integers(1, G + 1))
        _, want = jax.lax.top_k(jnp.asarray(prio), r)
        got = td.dllm_rows(torch.from_numpy(prio), r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dllm_rows_decided_by_ties_token_exact(pair, monkeypatch):
    """A dLLM generation in which, at some step, the r-th and (r+1)-th
    priorities tie, so the re-forwarded set is decided by the tie order:
    token-exact with JAX all the same."""
    ties = []
    rows = td.dllm_rows

    def spy(prio, r):
        s = torch.sort(prio, descending=True).values
        ties.append(r < prio.numel() and bool(s[r - 1] == s[r]))
        return rows(prio, r)

    monkeypatch.setattr(td, "dllm_rows", spy)
    ref, got, _ = _run_case(pair, "dllm_partial")
    np.testing.assert_array_equal(got, ref)
    assert any(ties), "no step's row set was decided by a tie"


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

REFUSED = [
    (dict(dllm_cache=8, kv8=True), {}),
    (dict(dllm_cache=8, mixed=True), {}),
    (dict(dllm_cache=8, verbose=True), {}),
    (dict(verbose=True, kv8=True), {}),
    (dict(verbose=True, mixed=True), {}),
    (dict(mixed=True), dict(prefix_lm=False)),
    (dict(mixed=True, verbose=True), dict(prefix_lm=False)),
]


@pytest.mark.parametrize("kw,gkw", REFUSED)
def test_refusals_match_jax(pair, kw, gkw):
    """The combinations JAX's generate refuses, with its messages; the
    port's act_int8_prefill is the mixed split (JAX's act_int8_prefill +
    decode_params)."""
    p, m = pair
    gen = GenerationConfig(max_new_tokens=8, block_length=8, steps=4,
                           **gkw)
    jpre, tpre = _prefix(1, 6, seed=12)
    kw = dict(kw)
    mixed = kw.pop("mixed", False)
    with pytest.raises(NotImplementedError) as jerr:
        jd.generate(p, LCFG, jpre, gen, **kw,
                    **(dict(act_int8_prefill=True, decode_params=p)
                       if mixed else {}))
    with pytest.raises(NotImplementedError) as terr:
        td.generate(m, tpre, gen, act_int8_prefill=mixed, **kw)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# bf16 and grouped int4, teacher-forced
# ---------------------------------------------------------------------------

TF_MODEL = """
import jax, jax.numpy as jnp, numpy as np
from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa

CFG = LaViDaConfig(
    llada=tiny_llada_config(d_model=512, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=1024),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))

def tf_model(layout):
    jm = JLaViDa.random_init(CFG, 0, jnp.bfloat16)
    jm.params["llada"] = jax.tree.map(
        lambda a: a * 4.0 if a.ndim >= 2 else a, jm.params["llada"])
    if layout == "int4":
        return jm.to_serving_layout("int4", fuse=False)
    jm.params["llada"] = jl.unstack_blocks(jm.params["llada"])
    return jm
"""

TF_GEN = dict(max_new_tokens=32, block_length=32, steps=16, prefix_lm=True)
TF_P = 40


def _tf_model(layout):
    ns = {}
    exec(TF_MODEL, ns)
    jm = ns["tf_model"](layout)
    return LaViDa.from_jax(jm.cfg, jax.tree.map(np.asarray, jm.params),
                           "cpu")


@pytest.fixture(scope="module")
def tf_ref(tmp_path_factory):
    """JAX's recorded states, per layout: the no-cache denoise (x before
    each step, that step's answer logits) and the dLLM steps (x, the
    logits cache, changed, stale and the K/V cache before each step, and
    the logits cache after it)."""
    return strict_jax(TF_MODEL + f"""
from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.generation import diffusion as jd
from lavida_mod_tpu.ops import sampling as js

jl.FORCE_FUSED_INTERPRET = True
gen = GenerationConfig(**{TF_GEN!r})
P, G = {TF_P}, gen.max_new_tokens
for layout in ("bf16", "int4"):
    jm = tf_model(layout)
    p, lc = jm.params["llada"], jm.cfg.llada
    mask = lc.mask_token_id
    prefix = jnp.asarray(np.random.default_rng(13).standard_normal(
        (1, P, lc.d_model)), jnp.bfloat16)
    OUT[layout + "/prefix"] = np.asarray(prefix.astype(jnp.float32))
    x = jnp.full((1, G), mask, jnp.int32)
    k_table, block_end = jd.build_control_table(np.asarray(x), 0, G, gen,
                                                mask)
    xs, lg = [np.asarray(x)], []
    for i in range(k_table.shape[0]):     # _denoise_scan_full, a step each
        e = jnp.concatenate([prefix, jl.embed_tokens(p, x)], axis=1)
        logits = jl.forward(p, lc, e)[0][:, P:]
        x = js.denoise_commit(x, logits, x == mask,
                              jnp.asarray(k_table[i]),
                              jnp.asarray(block_end[i]))
        xs.append(np.asarray(x))
        lg.append(np.asarray(logits))
    OUT[layout + "/nc_xs"], OUT[layout + "/nc_logits"] = (np.stack(xs),
                                                          np.stack(lg))
    # _generate_dllm_fused, r = 8 < G, a step each
    r = 8
    _, c = jl.forward(p, lc, prefix, use_cache=True, return_logits=False,
                      use_flash=True)
    if isinstance(c, list):
        cache = [(jnp.pad(k, ((0, 0), (0, G), (0, 0), (0, 0))),
                  jnp.pad(v, ((0, 0), (0, G), (0, 0), (0, 0)))) for k, v in c]
    else:
        cache = [(jnp.pad(c["k"][i], ((0, 0), (0, G), (0, 0), (0, 0))),
                  jnp.pad(c["v"][i], ((0, 0), (0, G), (0, 0), (0, 0))))
                 for i in range(lc.n_layers)]
    x = jnp.full((1, G), mask, jnp.int32)
    logits_c, cache = jl.forward(p, lc, jl.embed_tokens(p, x),
                                 positions=jnp.arange(P, P + G),
                                 kv_cache=cache, kv_write_index=P,
                                 use_cache=True)
    logits_c = logits_c.astype(jnp.bfloat16)
    changed = jnp.zeros((G,), bool)
    stale = jnp.zeros((G,), jnp.float32)
    rec = {{k: [] for k in ("x", "lc", "changed", "stale", "cache",
                            "lc_after", "x_after")}}
    for i in range(k_table.shape[0]):
        rec["x"].append(np.asarray(x))
        rec["lc"].append(np.asarray(logits_c.astype(jnp.float32)))
        rec["changed"].append(np.asarray(changed))
        rec["stale"].append(np.asarray(stale))
        rec["cache"].append(np.stack([np.asarray(a.astype(jnp.float32))
                                      for kv in cache for a in kv]))
        masked = x[0] == mask
        prio = (changed.astype(jnp.float32) * 1e6
                + jnp.where(masked, stale, -1e6))
        _, pos = jax.lax.top_k(prio, r)
        logits_r, cache = jl.forward(
            p, lc, jl.embed_tokens(p, x[:, pos]), positions=P + pos,
            kv_cache=cache, kv_scatter_idx=P + pos, use_cache=True)
        logits_c = logits_c.at[:, pos].set(logits_r.astype(logits_c.dtype))
        x_new = js.denoise_commit(x, logits_c.astype(jnp.float32), x == mask,
                                  jnp.asarray(k_table[i]),
                                  jnp.asarray(block_end[i]))
        changed = (x_new != x)[0]
        fresh = jnp.zeros((G,), bool).at[pos].set(True)
        stale = jnp.where(fresh, 0.0, stale + 1.0)
        x = x_new
        rec["lc_after"].append(np.asarray(logits_c.astype(jnp.float32)))
        rec["x_after"].append(np.asarray(x))
    for k, v in rec.items():
        OUT[layout + "/dllm_" + k] = np.stack(v)
""", tmp_path_factory.mktemp("tf"), timeout=1200)


@pytest.mark.parametrize("layout", ["bf16", "int4"])
def test_nocache_teacher_forced(tf_ref, layout):
    tm = _tf_model(layout)
    lm = tm.llada
    prefix = torch.from_numpy(tf_ref[layout + "/prefix"]).bfloat16()
    gen = GenerationConfig(**TF_GEN)

    def step(x):
        e = torch.cat([prefix, lm.embed_tokens(x)], dim=1)
        return lm(e, logits_from=TF_P)[0]

    ex = teacher_forced(tm, prefix, gen, tf_ref[layout + "/nc_xs"],
                        tf_ref[layout + "/nc_logits"], step=step)
    print(f"{layout} no-cache near-ties: {ex}")


@pytest.mark.parametrize("layout", ["bf16", "int4"])
def test_dllm_teacher_forced(tf_ref, layout):
    """Each dLLM step run from JAX's state before it (x, the bf16 logits
    cache, changed, stale, the K/V cache): the refreshed rows' logits
    within 5 % of max |logit|, the step's commits equal but for counted
    near-ties."""
    tm = _tf_model(layout)
    lm = tm.llada
    gen = GenerationConfig(**TF_GEN)
    G = gen.max_new_tokens
    k_table, block_end = td.build_control_table(
        np.full((1, G), MASK, np.int64), 0, G, gen, MASK)
    rec = {k[len(layout) + 6:]: v for k, v in tf_ref.items()
           if k.startswith(layout + "/dllm_")}
    near = 0
    for i in range(k_table.shape[0]):
        flat = torch.from_numpy(rec["cache"][i]).bfloat16()
        cache = [(flat[2 * li], flat[2 * li + 1])
                 for li in range(lm.cfg.n_layers)]
        with torch.no_grad():
            x, lc, _, _ = td.dllm_step(
                lm, torch.from_numpy(rec["x"][i]).long(),
                torch.from_numpy(rec["lc"][i]).bfloat16(),
                torch.from_numpy(rec["changed"][i]),
                torch.from_numpy(rec["stale"][i]), cache, None,
                torch.as_tensor(k_table[i]).long(), int(block_end[i]), 8,
                None, 0.0, "low_confidence")
        ref = torch.from_numpy(rec["lc_after"][i])
        assert _rel(lc.float(), ref) < 0.05, i
        want = torch.from_numpy(rec["x_after"][i]).long()
        if not torch.equal(x, want):
            # a near-tie of the commit: the confidences at JAX's logits
            x0 = torch.from_numpy(rec["x"][i]).long()
            conf = torch.softmax(ref[0], -1).amax(-1)[x0[0] == MASK]
            k = int(k_table[i, 0])
            top = torch.sort(conf.log(), descending=True).values
            delta = (lc.float() - ref).abs().max().item()
            assert k < len(top) and (top[k - 1] - top[k]) <= 4 * delta, i
            near += 1
    print(f"{layout} dLLM steps with a near-tie commit: {near}")


# ---------------------------------------------------------------------------
# the LaViDa entry with an image, and the CLIs
# ---------------------------------------------------------------------------

CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))


def test_lavida_generate_nocache_and_draft_as_jax():
    jm = JLaViDa.random_init(CFG, 0, jnp.float32)
    jm.params["llada"] = jl.unstack_blocks(jax.tree.map(
        lambda a: a * 10.0 if a.ndim >= 2 else a, jm.params["llada"]))
    tm = LaViDa.from_jax(CFG, jax.tree.map(np.asarray, jm.params), "cpu")
    nw, nh = anyres_grid_shape((100, 60), CFG.vision.grid_pinpoints, 56)
    rng = np.random.default_rng(14)
    views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(np.float32)
    ids = np.concatenate([[5, 6, -200], rng.integers(3, 400, 5)])
    draft = _draft(1, seed=15)[0]
    gen = GenerationConfig(max_new_tokens=16, block_length=8, steps=8,
                           prefix_lm=False)
    for kw in (dict(), dict(draft_tokens=draft),
               dict(draft_tokens=draft, prefix_bucket=64)):
        ref = jm.generate(ids, [views], [(100, 60)], gen, **kw)
        got = tm.generate(ids, [views], [(100, 60)], gen, **kw)
        np.testing.assert_array_equal(got, ref)


def _jax_free(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c",
                           "import sys; sys.modules['jax'] = None\n" + code],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_predict_no_prefix_cache_runs():
    for extra in ("", ", '--batch', '3'"):
        out = _jax_free(
            "from lavida_mod_tpu_torch.predict import main\n"
            "main(['--tiny', '--device', 'cpu', '--no-prefix-cache', "
            f"'--max-new-tokens', '16', '--step-per-block', '8'{extra}])")
        assert out.returncode == 0, out.stderr[-3000:]
        assert "no prefix cache" in out.stdout
        assert "[predict] latency:" in out.stdout
    bad = _jax_free("from lavida_mod_tpu_torch.predict import main\n"
                    "main(['--tiny', '--device', 'cpu', '--mixed', "
                    "'--no-prefix-cache'])")
    assert bad.returncode != 0 and "prefix-cache mode" in bad.stderr


def test_predict_fim_runs():
    out = _jax_free("from lavida_mod_tpu_torch.predict_fim import main\n"
                    "r = main(['--tiny', '--device', 'cpu'])\n"
                    "print('G', len(r['ids']), 'TD', len(r['draft']))")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "holes filled: 256 / 256" in out.stdout
    assert "G 256 TD 24" in out.stdout


def test_tiny_worker_answers_no_cache_requests(tmp_path):
    """A worker built by the port's CLI on the CPU (the default weight-only
    int8 layout) answers `prefix_lm: false` requests, alone and merged
    into one batch, as its eval model does."""
    import json
    import urllib.request

    from lavida_mod_tpu_torch import rehearse_8b_load as r
    from lavida_mod_tpu_torch.config import tiny_llada_config as ttiny
    from lavida_mod_tpu_torch.predict import tiny_config
    from lavida_mod_tpu_torch.serve import worker as tw

    cfg = tiny_config().replace(llada=ttiny(
        vocab_size=126464, embedding_size=126464, mask_token_id=126336,
        eos_token_id=126081, pad_token_id=126081))
    r.synthesize(torch, str(tmp_path), cfg, "cpu")
    worker = tw.build_worker(tw.parse_args([
        "--model-path", str(tmp_path), "--device", "cpu",
        "--decode-batch", "2", "--batch-window-ms", "2000"]))
    em = worker.eval_model
    server = worker.server("127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/worker_generate"
    kw = {"max_new_tokens": 16, "step_per_block": 8, "prefix_lm": False}

    def post(text):
        req = urllib.request.Request(url, json.dumps({
            "prompt": text, "gen_kwargs": kw}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as f:
            return json.loads(f.read())

    try:
        texts = ["Say hello.", "Name a color."]
        answers = [None, None]

        def call(i):
            answers[i] = post(texts[i])

        ts = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        assert worker.batcher.served_sizes == [(2, 2)]
        assert [a["text"] for a in answers] == \
            em.generate_until_batch(texts, [[], []], kw)
        one = post(texts[0])
        assert one["text"] == em.generate_until(texts[0], [], kw)
        assert worker.batcher.served_sizes[-1] == (1, 1)
    finally:
        worker.close()
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# on the card: the tiny paths against the same weights on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tiny_pair(device):
    """A tiny bf16 model with seeded weights on the CPU, the same weights
    on `device`, and a seeded prefix [1, 40, D]."""
    from lavida_mod_tpu_torch.config import tiny_llada_config as ttiny

    cpu = LLaDA(ttiny(), "cpu", torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.2)
    other = LLaDA(ttiny(), device, torch.bfloat16)
    other.load_state_dict(cpu.state_dict())
    return cpu, other, torch.randn(1, 40, cpu.cfg.d_model,
                                   generator=g).bfloat16()


@pytest.mark.parametrize("route", chip_smoke.TINY_ROUTES)
def test_tiny_route_steps_on_two_cpu_copies(route):
    """chip_smoke's step-by-step card check run with a second CPU copy in
    the card's place: every step runs, and the two agree exactly."""
    cpu, other, prefix = _tiny_pair("cpu")
    n, worst, near = chip_smoke.tiny_route_steps(torch, cpu, other, prefix,
                                                 route)
    assert n == 16 and worst == 0.0 and near == 0


@pytest.mark.parametrize("route", chip_smoke.TINY_ROUTES)
def test_tiny_paths_on_cuda_match_cpu(cuda, route):
    """Each step of the route on the card from the CPU's state before it:
    logits (and for dLLM the K/V the scatter mode writes) within 5e-2 of
    max |CPU value|, commits equal but for near-ties; then the whole
    generation on the card leaves no mask."""
    from lavida_mod_tpu_torch.config import GenerationConfig as TGen

    cpu, gpu, prefix = _tiny_pair(cuda)
    n, worst, near = chip_smoke.tiny_route_steps(torch, cpu, gpu, prefix,
                                                 route)
    print(f"{route}: {n} steps, worst {worst:.3e}, near-ties {near}")
    gen = TGen(max_new_tokens=32, block_length=32, steps=16,
               prefix_lm=route != "no cache")
    kw = {"dLLM r=8": dict(dllm_cache=8), "verbose": dict(verbose=True),
          "draft": dict(draft_tokens=_draft(1)), "no cache": {}}[route]
    out = td.generate(gpu, prefix.to(cuda), gen, **kw)
    if route == "verbose":
        out, hist = out
        assert len(hist) == 16
    assert (out != MASK).all() and out.shape == (1, 32)
