"""The port's MC log-likelihood (generation/log_likelihood.py) and
`LavidaEvalModel.loglikelihood` against the JAX package on the CPU.

  - The stratified mask counts equal those of JAX's jitted expression
    (log_likelihood.py:52-57, compiled per (Ta, b) with k traced, as in
    `_mc_round`) for every k in 1..Ta over a grid of Ta and b (b <= 64),
    the exact .5 points included.
  - One round with JAX's draws injected (its k's counts and its
    permutations) equals `_mc_round` within 1e-5 relative in f32, at
    several (Ta, b, forward_chunk), dense and through the plain
    short-attention; forward chunking is exact (the JAX test's 2e-6);
    a one-token answer gives log softmax at the masked row exactly.
  - The estimator's own draws: finite, negative, stable across seeds, and
    ranking the model's argmax continuation over a shifted one.
  - The adapter: a one-token continuation (where both estimators are
    exact) scores as JAX's adapter does, in f32 and in the mixed layout,
    whose scoring runs the int8 prefill tree weight-only (and with
    loglik_act_int8 its W8A8 linears); continuations are cut at 300
    tokens; Dream raises.
  - On a card (`-k cuda`): one round of a tiny bf16 model with the same
    injected draws, card (short-attention kernel) against CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.generation.log_likelihood import _mc_round
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.generation import log_likelihood as tll
from lavida_mod_tpu_torch.models.llada import LLaDA

torch.set_num_threads(2)

LCFG = tiny_llada_config()


@functools.partial(jax.jit, static_argnames=("Ta", "b"))
def _jax_counts(k, Ta, b):
    x = jnp.round(jnp.linspace(
        k.astype(jnp.float32), k.astype(jnp.float32) + (b - 1) * (Ta / b),
        b)).astype(jnp.int32)
    return ((x - 1) % Ta) + 1


@functools.partial(jax.jit, static_argnames=("Ta", "b"))
def _jax_draws(key, Ta, b):
    """_mc_round's draws (log_likelihood.py:49-62): k, counts, ranks."""
    kk, kp = jax.random.split(key)
    k = jax.random.randint(kk, (), 1, Ta + 1)
    ranks = jax.vmap(lambda pk: jax.random.permutation(pk, Ta))(
        jax.random.split(kp, b))
    return k, ranks


@pytest.mark.parametrize("bs", [(1, 2, 3, 4, 5, 6, 7, 8),
                                (12, 13, 14, 15, 16),
                                (20, 24, 28, 32, 48, 64)])
def test_mask_counts_equal_jax(bs):
    bad = []
    for b in bs:
        for Ta in (1, 2, 3, 4, 5, 6, 8, 9, 12, 14, 16, 18, 24, 26, 28, 36,
                   56, 62, 100, 300):
            for k in range(1, Ta + 1):
                want = np.asarray(_jax_counts(jnp.int32(k), Ta=Ta, b=b))
                got = tll.mask_counts(k, Ta, b)
                if not (got == want).all():
                    bad.append((Ta, b, k))
    assert not bad, bad[:10]


def _pair(scale=1.0):
    p = jl.init_params(LCFG, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a * scale if a.ndim >= 2 else a, p)
    m = LLaDA(LCFG, "cpu")
    sd = state_dict_from_jax({"llada": jax.tree.map(
        np.asarray, jl.unstack_blocks(p))})
    m.load_state_dict({k[len("llada."):]: v for k, v in sd.items()})
    prefix = jl.embed_tokens(p, jnp.arange(5, 13)[None])
    return p, m, prefix, torch.from_numpy(np.array(prefix))


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _injected(m, tprefix, answer, key, b, **kw):
    Ta = answer.shape[0]
    k, ranks = _jax_draws(key, Ta=Ta, b=b)
    counts = np.asarray(_jax_counts(k, Ta=Ta, b=b))
    assert (tll.mask_counts(int(k), Ta, b) == counts).all()
    return float(tll.mc_round(
        m, tprefix, torch.from_numpy(np.asarray(answer)).long(),
        torch.from_numpy(counts).long(),
        torch.from_numpy(np.asarray(ranks)).long(), **kw))


@pytest.mark.parametrize("Ta,b,chunk,seed", [(12, 8, 8, 3), (12, 8, 4, 4),
                                             (24, 16, 8, 5), (7, 4, 2, 6),
                                             (130, 4, 4, 7)])
def test_round_with_injected_draws_matches_mc_round(tiny, Ta, b, chunk,
                                                    seed):
    p, m, jprefix, tprefix = tiny
    answer = jnp.asarray(np.random.default_rng(seed).integers(5, 500, Ta))
    key = jax.random.PRNGKey(seed)
    ref = float(_mc_round(p, LCFG, jprefix, answer, key, b,
                          forward_chunk=chunk))
    for use_flash in (False, True):
        got = _injected(m, tprefix, answer, key, b, forward_chunk=chunk,
                        use_flash=use_flash)
        assert abs(got - ref) / abs(ref) < 1e-5, (use_flash, got, ref)


def test_forward_chunking_is_exact(tiny):
    _, m, _, tprefix = tiny
    answer = torch.from_numpy(np.random.default_rng(1).integers(5, 500, 8))
    g = torch.Generator().manual_seed(3)
    counts, ranks = tll.draw_round(g, 8, 4, "cpu")
    whole = tll.mc_round(m, tprefix, answer, counts, ranks, forward_chunk=4)
    chunked = tll.mc_round(m, tprefix, answer, counts, ranks,
                           forward_chunk=2)
    np.testing.assert_allclose(float(whole), float(chunked), rtol=2e-6)


def test_single_token_is_exact(tiny):
    p, m, jprefix, tprefix = tiny
    ll = tll.get_log_likelihood(m, tprefix, [42], mc_num=4, batch_size=2)
    mask_embed = jl.embed_tokens(p, jnp.array([[LCFG.mask_token_id]]))
    logits, _ = jl.forward(p, LCFG, jnp.concatenate([jprefix, mask_embed],
                                                    axis=1))
    expect = float(jax.nn.log_softmax(logits[0, -1])[42])
    np.testing.assert_allclose(ll, expect, atol=1e-5)


def test_estimates_finite_negative_stable_and_ranked(tiny):
    _, m, _, tprefix = tiny
    ans = np.random.default_rng(0).integers(3, 400, 12)
    ll = tll.get_log_likelihood(m, tprefix, ans, mc_num=16, batch_size=8)
    assert np.isfinite(ll) and ll < 0.0
    a, b = (tll.get_log_likelihood(
        m, tprefix, ans[:6], mc_num=64, batch_size=16,
        generator=torch.Generator().manual_seed(s)) for s in (1, 2))
    assert abs(a - b) / abs(a) < 0.25, (a, b)
    with torch.no_grad():
        x = torch.full((1, 4), LCFG.mask_token_id)
        logits, _ = m(torch.cat([tprefix, m.embed_tokens(x)], dim=1))
    good = logits[0, -4:].argmax(-1).numpy()
    bad = (good + 97) % LCFG.vocab_size
    assert tll.get_log_likelihood(m, tprefix, good, mc_num=32) > \
        tll.get_log_likelihood(m, tprefix, bad, mc_num=32)


# ---------------------------------------------------------------------------
# the adapter
# ---------------------------------------------------------------------------

CFG = LaViDaConfig(
    llada=tiny_llada_config(d_model=512, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=1024),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))


class CharTokenizer:
    """One id per character, the same for both packages' adapters."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([3 + ord(c) % 400 for c in text])


@pytest.fixture(scope="module")
def adapters():
    from PIL import Image

    from lavida_mod_tpu.eval.adapter import LavidaEvalModel as JEval
    from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
    from lavida_mod_tpu_torch.eval.adapter import LavidaEvalModel as TEval
    from lavida_mod_tpu_torch.models.lavida import LaViDa

    out = {}
    for layout in ("f32", "mixed"):
        dt = jnp.float32 if layout == "f32" else jnp.bfloat16
        jm = JLaViDa.random_init(CFG, 0, dt)
        jm.params["llada"] = jax.tree.map(
            lambda a: a * 4.0 if a.ndim >= 2 else a, jm.params["llada"])
        if layout == "mixed":
            jm = jm.to_serving_layout("mixed", fuse=True)
        else:
            jm.params["llada"] = jl.unstack_blocks(jm.params["llada"])
        pre = (None if jm.prefill_params is None
               else jax.tree.map(np.asarray, jm.prefill_params))
        tm = LaViDa.from_jax(jm.cfg, jax.tree.map(np.asarray, jm.params),
                             "cpu", prefill_params=pre)
        assert tm.mixed == (layout == "mixed")
        out[layout] = (JEval(jm, CharTokenizer()), TEval(tm, CharTokenizer()))
    img = Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (60, 100, 3), dtype=np.uint8))
    return out, img


@pytest.mark.parametrize("layout,act_int8,band", [
    ("f32", False, 1e-5), ("mixed", False, 2e-2), ("mixed", True, 2e-2)])
def test_one_token_continuation_scores_as_jax(adapters, layout, act_int8,
                                              band):
    (jev, tev), img = adapters[0][layout], adapters[1]
    jev.loglik_act_int8 = tev.loglik_act_int8 = act_int8
    want = jev.loglikelihood("What is it?", [img], "a")
    got = tev.loglikelihood("What is it?", [img], "a")
    assert np.isfinite(got) and got < 0
    assert abs(got - want) / abs(want) < band, (got, want)


def test_mixed_scores_on_the_int8_tree(adapters, monkeypatch):
    """The mixed adapter's estimator runs the int8 prefill tree
    (weight-only by default), gets the prompt's prefix and an answer cut
    at 300 tokens; its one-token score differs from the int4 tree's."""
    from lavida_mod_tpu_torch.eval import adapter as tad

    (_, tev), img = adapters[0]["mixed"], adapters[1]
    tev.loglik_act_int8 = False
    seen = {}
    real = tad.get_log_likelihood

    def spy(model, prefix, ans, **kw):
        seen.update(kw, ans=len(ans), P=prefix.shape[1])
        return real(model, prefix, ans, **kw)

    monkeypatch.setattr(tad, "get_log_likelihood", spy)
    tev.mc_num = 2
    tev.loglikelihood("q", [img], "x" * 400)
    assert seen["ans"] == 300 and seen["prefill_tree"] is True
    assert seen["act_int8"] is False and seen["mc_num"] == 2
    tev.mc_num = 16
    lm = tev.model.llada
    prefix = tev.model.encode_prompt(*tev._build_inputs("q", [img])[:3])
    tree = tll.get_log_likelihood(lm, prefix, [100], mc_num=2,
                                  batch_size=2, prefill_tree=True)
    decode = tll.get_log_likelihood(lm, prefix, [100], mc_num=2,
                                    batch_size=2)
    assert tree != decode


def test_dream_loglikelihood_raises():
    from lavida_mod_tpu_torch.eval.adapter import LavidaEvalModel as TEval

    class M:
        lm_family = "dream"

        class cfg:
            class vision:
                class siglip:
                    image_size = 56

    with pytest.raises(NotImplementedError, match="Dream backbone"):
        TEval(M(), CharTokenizer()).loglikelihood("q", [], "a")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_round_on_cuda_matches_cpu(cuda):
    from lavida_mod_tpu_torch.config import tiny_llada_config as ttiny

    cpu = LLaDA(ttiny(), "cpu", torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.2)
    gpu = LLaDA(ttiny(), cuda, torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    prefix = torch.randn(1, 40, cpu.cfg.d_model, generator=g).bfloat16()
    answer = torch.randint(3, 400, (70,), generator=g)
    counts, ranks = tll.draw_round(g, 70, 16, "cpu")
    ref = float(tll.mc_round(cpu, prefix, answer, counts, ranks))
    got = float(tll.mc_round(gpu, prefix.to(cuda), answer.to(cuda),
                             counts.to(cuda), ranks.to(cuda),
                             use_flash=True))
    assert np.isfinite(got) and abs(got - ref) / abs(ref) < 2e-2, (got, ref)
