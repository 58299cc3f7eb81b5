"""The port's SHIRG (lavida_mod_tpu_torch.models.shirg) and SigLIP's bicubic
position table against the JAX package on the CPU, f32 unless stated.

  - the resized position table within 1e-6 (of its largest magnitude)
    of `jax.image.resize(.., "bicubic")` for larger and (antialiased)
    smaller grids, and the tower
    at 448^2 within 1e-5;
  - every scoring method, `edge_prior`, `distance_penalty` and
    `radial_weight` within 1e-6; the top-k indices equal, including a
    gated-off image whose 1024 scores all tie; the merge within 1e-6,
    with pairs and without; `process_shirg_2view` arrays equal;
  - `shirg_encode`: the selection and projection from JAX's tower
    features within 1e-5 for each method (merge included), and the whole
    encode within 1e-5 but for rows swapped at score near-ties (the tiny
    tower's 1e-6 error reorders scores that differ by ~1e-8: those rows
    are counted and must be the same rows); in bf16 (JAX in a strict
    child, tests/torch_jax_strict.py) the tower and the selection within
    3e-2 of the largest value; `generate(image_features=...)` token-exact
    in bf16 at temperature 0 on JAX's block;
  - `predict --shirg --tiny` runs without jax.
"""

import os
import pathlib
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
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import shirg as js
from lavida_mod_tpu.models import siglip as jsig
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.models import shirg as ts
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.models.siglip import interp_pos_embed
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = LaViDaConfig(llada=tiny_llada_config(),
                   vision=VisionConfig(siglip=tiny_siglip_config(),
                                       mm_hidden_size=32))
METHODS = ["base", "entropy", "edge", "edge_only", "custom", "full"]


@pytest.fixture(scope="module")
def models():
    jm = JLaViDa.random_init(CFG, 0, jnp.float32)
    jm.params["llada"] = jl.unstack_blocks(jax.tree.map(
        lambda a: a * 10.0 if a.ndim >= 2 else a, jm.params["llada"]))
    return jm, LaViDa.from_jax(CFG, jax.tree.map(np.asarray, jm.params),
                               "cpu")


def _views(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, 3, 448, 448)).astype(np.float32)


def _tokens(seed, B=2, N=64, D=16):
    return np.random.default_rng(seed).standard_normal(
        (B, N, D)).astype(np.float32)


def _close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the bicubic position table and the tower at 448^2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,grid", [(27, 32), (4, 32), (27, 16), (5, 3)])
def test_pos_embed_interpolation_matches_jax_resize(g, grid):
    """Within 1e-6 of the table's largest magnitude: JAX's own f32 weights
    and sums stand that far from the exact (f64) resize."""
    pe = np.random.default_rng(g).standard_normal((g * g, 8)).astype(
        np.float32)
    want = np.asarray(jsig._interp_pos_embed(jnp.asarray(pe), grid))
    _close(interp_pos_embed(torch.from_numpy(pe), grid), want,
           atol=1e-6 * max(1.0, np.abs(want).max()))


def test_tower_at_448_matches_jax(models):
    jm, tm = models
    views = _views()
    want = jsig.forward(jm.params["siglip"], CFG.vision.siglip,
                        jnp.asarray(views))
    with torch.no_grad():
        got = tm.siglip(torch.from_numpy(views))
        again = tm.siglip(torch.from_numpy(views))    # the cached table
    _close(got, want, atol=1e-5)
    assert torch.equal(got, again)
    table = tm.siglip.pos_table(1024)
    with torch.no_grad():
        tm.siglip.pos_embed.mul_(2.0)
    try:
        assert not torch.equal(tm.siglip.pos_table(1024), table)
    finally:
        with torch.no_grad():
            tm.siglip.pos_embed.mul_(0.5)


# ---------------------------------------------------------------------------
# scoring, top-k, merge, preprocessing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_scores_match_jax(method):
    tok = _tokens(1)
    sp = {"entropy_threshold": 0.5}   # the gates open on these tokens
    want = js.shirg_scores(jnp.asarray(tok), method=method, params=sp)
    _close(ts.shirg_scores(torch.from_numpy(tok), method=method, params=sp),
           want, atol=1e-6)
    txt = _tokens(2, N=5)
    _close(ts.shirg_scores(torch.from_numpy(tok), torch.from_numpy(txt),
                           method=method, params=sp),
           js.shirg_scores(jnp.asarray(tok), jnp.asarray(txt),
                           method=method, params=sp), atol=1e-6)


def test_random_scores_take_injected_noise():
    tok = _tokens(3)
    key = jax.random.PRNGKey(4)
    want = js.shirg_scores(jnp.asarray(tok), method="random", key=key)
    got = ts.shirg_scores(torch.from_numpy(tok), method="random",
                          noise=torch.from_numpy(np.asarray(want)))
    _close(got, want, atol=0)
    g = torch.Generator().manual_seed(0)
    drawn = ts.shirg_scores(torch.from_numpy(tok), method="random",
                            generator=g)
    assert drawn.shape == (2, 64) and 0 <= drawn.min() and drawn.max() < 1


def test_components_match_jax():
    tok = _tokens(5)
    _close(ts.edge_prior(torch.from_numpy(tok)),
           js.edge_prior(jnp.asarray(tok)), atol=1e-6)
    _close(ts.distance_penalty(torch.from_numpy(tok)),
           js.distance_penalty(jnp.asarray(tok)), atol=1e-6)
    for n, sigma in ((1024, 0.65), (64, 0.3), (50, 0.65)):
        _close(ts.radial_weight(n, sigma), js.radial_weight(n, sigma),
               atol=1e-6)


@pytest.mark.parametrize("case", ["random", "gated", "ties"])
def test_topk_indices_match_jax(case):
    rng = np.random.default_rng(6)
    if case == "random":
        scores = rng.random((2, 1024)).astype(np.float32)
    elif case == "gated":
        # attention-std above the entropy gate: `full` zeroes the image,
        # every score ties at 1e-6 after the budget epsilon
        tok = _tokens(7, B=1, N=1024, D=8)
        tok[0, 1::2] = -tok[0, 0]
        scores = np.asarray(js.shirg_scores(jnp.asarray(tok), method="full"))
        assert (scores == 0).all()
        tscores = ts.shirg_scores(torch.from_numpy(tok), method="full")
        assert (tscores == 0).all()
    else:   # blocks of equal values
        scores = rng.integers(0, 8, (2, 1024)).astype(np.float32) / 8
    _, want = jax.lax.top_k(jnp.asarray(scores) + 1e-6, 724)
    got = ts.topk_indices(torch.from_numpy(scores), 724)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tok = _tokens(8, B=scores.shape[0], N=1024, D=8)
    _close(ts.topk_select(torch.from_numpy(tok), torch.from_numpy(scores),
                          724),
           js.topk_select(jnp.asarray(tok), jnp.asarray(scores), 724),
           atol=0)


@pytest.mark.parametrize("case", ["clusters", "no_pairs", "chain"])
def test_merge_matches_jax(case):
    rng = np.random.default_rng(9)
    if case == "clusters":
        base = rng.standard_normal((2, 6, 16)).astype(np.float32)
        tok = np.concatenate([base + 0.01 * rng.standard_normal(base.shape)
                              for _ in range(3)], axis=1).astype(np.float32)
        threshold = 0.9
    elif case == "no_pairs":
        tok, threshold = _tokens(10, N=12, D=32), 0.999
    else:   # overlapping groups: an absorbed row cannot absorb again
        tok = (np.cumsum(rng.standard_normal((1, 40, 8)), axis=1)
               .astype(np.float32))
        threshold = 0.8
    want = np.asarray(js.merge_similar_tokens(jnp.asarray(tok), threshold))
    got = ts.merge_similar_tokens(torch.from_numpy(tok), threshold)
    _close(got, want, atol=1e-6)
    if case == "no_pairs":
        _close(got, tok, atol=0)
    else:
        assert np.abs(want - tok).max() > 1e-3     # merging happened


def test_merge_pad_noise_only_on_the_tail():
    tok = np.repeat(_tokens(11, B=1, N=1, D=8), 6, axis=1)
    g = torch.Generator().manual_seed(0)
    out = ts.merge_similar_tokens(torch.from_numpy(tok), 0.9, generator=g)
    _close(out[0, 0], tok[0, 0], atol=1e-6)
    assert (out[0, 1:] != torch.from_numpy(tok[0, 1:])).any()
    _close(out, tok, atol=1e-5)


@pytest.mark.parametrize("size", [(900, 600), (400, 300), (448, 448),
                                  (1024, 768)])
def test_process_shirg_2view_matches_jax(size):
    from PIL import Image

    from lavida_mod_tpu.data import SigLIPImageProcessor as JProc
    from lavida_mod_tpu_torch.data import SigLIPImageProcessor as TProc

    img = Image.fromarray(np.random.default_rng(12).integers(
        0, 255, (size[1], size[0], 3), dtype=np.uint8))
    want = js.process_shirg_2view(img, JProc(size=384))
    got = ts.process_shirg_2view(img, TProc(size=384))
    assert got.shape == (2, 3, 448, 448) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the whole encode
# ---------------------------------------------------------------------------

SELECT_CASES = [("base", None), ("entropy", None), ("full", None),
                ("full", {"merge_similar": True, "merge_threshold": 0.5}),
                ("edge", None)]


@pytest.mark.parametrize("method,sp", SELECT_CASES)
def test_selection_from_jax_features_matches_jax(models, method, sp):
    """Selection and projection on JAX's own tower features."""
    jm, tm = models
    views = _views(1)
    feats = jsig.forward(jm.params["siglip"], CFG.vision.siglip,
                         jnp.asarray(views))
    want = js.shirg_encode(jm.params, CFG, jnp.asarray(views), method=method,
                           selection_params=sp)
    with torch.no_grad():
        got = ts.shirg_select(tm, torch.from_numpy(np.asarray(feats)),
                              method=method, selection_params=sp)
    assert got.shape == (980, CFG.llada.d_model)
    _close(got, want, atol=1e-5)


def _rows_match(got, want, atol, max_swapped=8):
    """Equal rows within atol, except at positions whose rows are a
    permutation of JAX's rows there (a near-tie reordered): returns how
    many positions differ."""
    got, want = np.asarray(got), np.asarray(want)
    off = np.where(np.abs(got - want).max(axis=-1) > atol)[0]
    assert len(off) <= max_swapped, len(off)
    for i in off:
        assert np.abs(want[off] - got[i]).max(axis=-1).min() <= atol, i
    return len(off)


@pytest.mark.parametrize("method", ["base", "full"])
def test_shirg_encode_matches_jax(models, method):
    jm, tm = models
    views = _views(2)
    want = np.asarray(js.shirg_encode(jm.params, CFG, jnp.asarray(views),
                                      method=method))
    with torch.no_grad():
        got = ts.shirg_encode(tm, torch.from_numpy(views), method=method)
        batched = ts.shirg_encode(
            tm, torch.from_numpy(np.stack([views, _views(3)])),
            method=method)
        second = ts.shirg_encode(tm, torch.from_numpy(_views(3)),
                                 method=method)
    _close(got[:256], want[:256], atol=1e-5)         # the pooled view
    _rows_match(got.numpy(), want, atol=1e-5)
    assert batched.shape == (2, 980, CFG.llada.d_model)
    _close(batched[0], got, atol=1e-5)
    _close(batched[1], second, atol=1e-5)


_BF16_REF = """
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import (GenerationConfig, LaViDaConfig,
                                   VisionConfig, tiny_llada_config,
                                   tiny_siglip_config)
from lavida_mod_tpu.models import llada as jl, shirg as js, siglip as jsig
from lavida_mod_tpu.models.lavida import LaViDa
cfg = LaViDaConfig(llada=tiny_llada_config(),
                   vision=VisionConfig(siglip=tiny_siglip_config(),
                                       mm_hidden_size=32))
jm = LaViDa.random_init(cfg, 0, jnp.float32)
jm.params["llada"] = jl.unstack_blocks(jax.tree.map(
    lambda a: a * 10.0 if a.ndim >= 2 else a, jm.params["llada"]))
pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                  if a.dtype == jnp.float32 else a, jm.params)
views = jnp.asarray(IN["views"])
f32 = lambda a: np.asarray(a.astype(jnp.float32))
OUT["feats"] = f32(jsig.forward(pb["siglip"], cfg.vision.siglip, views))
block = js.shirg_encode(pb, cfg, views, method="full")
OUT["block"] = f32(block)
gen = GenerationConfig(max_new_tokens=16, block_length=8, prefix_lm=True,
                       remasking="low_confidence")
# LaViDa.generate's own route (encode_prompt with image_features, then
# diffusion.generate) with the prefill through the Pallas kernel, as the
# port's generate prefills through its kernel
from lavida_mod_tpu.generation import diffusion as jd
prefix = LaViDa(cfg, pb).encode_prompt(IN["ids"], image_features=[block])
OUT["tokens"] = np.asarray(jd.generate(pb["llada"], cfg.llada, prefix, gen,
                                       use_flash_prefill=True))[0]
"""


@pytest.fixture(scope="module")
def bf16_ref(models, tmp_path_factory):
    """JAX's bf16 tower features, SHIRG block (method full) and generation
    over that block, from a strict child (excess precision off), and the
    port's bf16 model of the same weights."""
    jm, _ = models
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 else a, jm.params)
    tb = LaViDa.from_jax(CFG, jax.tree.map(np.asarray, pb), "cpu")
    ref = strict_jax(_BF16_REF, tmp_path_factory.mktemp("shirg_bf16"),
                     {"views": _views(5), "ids": np.array([5, 6, -200, 7,
                                                           8, 9])})
    return ref, tb


def test_shirg_encode_bf16_band(bf16_ref):
    """bf16: the tower and the pooled view within 3e-2 of the largest
    value, and the selection + projection from JAX's bf16 features within
    that band (rows swapped at near-ties counted, the same rows)."""
    ref, tb = bf16_ref
    with torch.no_grad():
        feats = tb.siglip(torch.from_numpy(_views(5)))
        got = ts.shirg_encode(tb, torch.from_numpy(_views(5)),
                              method="full")
        sel = ts.shirg_select(tb, torch.from_numpy(ref["feats"]).bfloat16(),
                              method="full")
    assert feats.dtype == got.dtype == torch.bfloat16
    _close(feats.float(), ref["feats"],
           atol=3e-2 * np.abs(ref["feats"]).max())
    band = 3e-2 * np.abs(ref["block"]).max()
    _close(got[:256].float(), ref["block"][:256], atol=band)
    _rows_match(sel.float().numpy(), ref["block"], atol=band)


def test_generate_with_image_features_token_exact_bf16(bf16_ref):
    """JAX's bf16 SHIRG block spliced into the prompt by both packages'
    generate (LLaDA sampler, prefix cache, temperature 0)."""
    ref, tb = bf16_ref
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           prefix_lm=True, remasking="low_confidence")
    block = torch.from_numpy(ref["block"]).bfloat16()
    got = tb.generate(np.array([5, 6, -200, 7, 8, 9]), gen=gen,
                      image_features=[block])
    np.testing.assert_array_equal(got, ref["tokens"])
    assert (got != CFG.llada.mask_token_id).all()
    assert len(set(got.tolist())) >= 4, "degenerate reference tokens"


def test_predict_shirg_cli_runs_without_jax(tmp_path):
    from PIL import Image

    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(13).integers(
        0, 255, (300, 500, 3), dtype=np.uint8)).save(img)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from lavida_mod_tpu_torch.predict import main\n"
            "for extra in ([], ['--image', sys.argv[1]]):\n"
            "    main(['--tiny', '--device', 'cpu', '--shirg',\n"
            "          '--shirg-method', 'full', '--max-new-tokens', '8',\n"
            "          '--step-per-block', '4'] + extra)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code, str(img)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[predict] shirg: 980 tokens") == 2
    assert out.stdout.count("[predict] output ids:") == 2
