"""The port's resamplers (models/resampler.py, models/qformer.py) against
the JAX package's, on the CPU at small widths.

  - masked_drop in its three modes and with its skip, the draws injected:
    JAX's jax.random draws (the skip and the range ratio, decided on the
    host, and the noise) are given to the port, which must keep the same
    tokens in the same order, ties in the noise broken by position as
    jnp.argsort's stable sort breaks them; exact; on the card (-k cuda),
    build_resampler("masked_drop") draws there and keeps the rows that
    the same draws keep on the CPU, exact;
  - spatial_pool: max exact, average within 1e-6;
  - the perceiver and the Q-Former with JAX's init_params weights moved by
    seeded noise: f32 within 1e-5 of max |JAX| (read 2e-7 - 3e-7), bf16
    with JAX in the strict child (tests/torch_jax_strict.py) within 1e-2
    (read: both bit-equal; the margin is for PyTorch's CPU bf16 matmul,
    which may sum in another order than XLA's);
  - the Q-Former's converter on a synthetic state dict of the torch
    module's names, bit-equal to JAX's; build_resampler's registry,
    including the reference's quirk that `depth` feeds the Q-Former's
    cross_attention_freq.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.models import qformer as jqf
from lavida_mod_tpu.models import resampler as jres
from lavida_mod_tpu_torch.config import QformerConfig
from lavida_mod_tpu_torch.convert import module_from_jax, \
    module_state_from_jax, perceiver_from_jax
from lavida_mod_tpu_torch.models import qformer as tqf
from lavida_mod_tpu_torch.models import resampler as tres
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

F32_TOL, BF16_TOL = 1e-5, 1e-2
QCFG = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=64, encoder_width=24, num_query_tokens=8,
            cross_attention_freq=2)


def _moved(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32) if hasattr(a, "shape") else a,
        params)


def _rel(t, j):
    t = t.detach().float().numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape
    return float(np.abs(t - j).max() / np.abs(j).max())


def _feats(seed, B=2, T=16, D=24):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32)


def _jax_draws(key, N, T, lower=0.25, upper=0.75):
    """The draws JAX's masked_drop makes from `key` (resampler.py:50-67)."""
    ks, kr, kn = jax.random.split(key, 3)
    return {"skip": float(jax.random.uniform(ks, ())),
            "ratio": float(jax.random.uniform(kr, (), minval=lower,
                                              maxval=upper)),
            "noise": np.asarray(jax.random.uniform(kn, (N, T)))}


@pytest.mark.parametrize("mode,kw", [
    ("fixed", {}), ("fixed", dict(ratio=0.3)), ("range", {}),
    ("range", dict(ratio_lower=0.05, ratio_upper=0.1)), ("cls_only", {}),
    ("fixed", dict(skip_percentage=0.5)), ("range",
                                            dict(skip_percentage=0.99))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_drop_with_jax_draws(mode, kw, seed):
    f = _feats(seed, B=3, T=25)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jres.masked_drop(jnp.asarray(f), key, mode=mode, **kw))
    draws = _jax_draws(key, 3, 25, kw.get("ratio_lower", 0.25),
                       kw.get("ratio_upper", 0.75))
    got = tres.masked_drop(torch.from_numpy(f), mode=mode, draws=draws, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_drop_ties_keep_jax_order():
    """Equal noise values: the earlier token first, as jnp.argsort."""
    f = _feats(3, B=2, T=12)
    noise = np.repeat(np.array([[0.5, 0.25, 0.5, 0.75]], np.float32), 3,
                      axis=1).repeat(2, axis=0)
    j = jnp.take_along_axis(jnp.asarray(f), jnp.argsort(
        jnp.asarray(noise), axis=1)[:, :7, None], axis=1)
    got = tres.masked_drop(torch.from_numpy(f), ratio=7 / 12,
                           draws={"noise": noise})
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))


def test_masked_drop_generator_and_passthrough():
    f = torch.from_numpy(_feats(4, T=20))
    assert tres.masked_drop(f, training=False) is f
    a = tres.masked_drop(f, torch.Generator().manual_seed(5), mode="range")
    b = tres.masked_drop(f, torch.Generator().manual_seed(5), mode="range")
    assert torch.equal(a, b) and 5 <= a.shape[1] <= 15
    assert tres.masked_drop(f, torch.Generator(), mode="cls_only").shape == \
        (2, 1, 24)
    with pytest.raises(ValueError, match="masked drop mode"):
        tres.masked_drop(f, torch.Generator(), mode="nope")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the draws are made on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("mode,kw", [("fixed", {}), ("fixed", dict(
    ratio=0.3)), ("range", {}), ("range", dict(skip_percentage=0.5))])
def test_masked_drop_on_cuda(cuda, mode, kw):
    """build_resampler("masked_drop") on CUDA features draws on the card
    and keeps the rows that the same draws keep on the CPU."""
    f = torch.from_numpy(_feats(5, B=3, T=577, D=64))
    m = tres.build_resampler("masked_drop", mode=mode, **kw)
    for seed in range(4):
        g = torch.Generator(cuda).manual_seed(seed)
        state = g.get_state()
        got = m(f.to(cuda), g, training=True)
        assert got.device.type == "cuda"
        # the same draws again, in masked_drop's order, then on the CPU
        # (past a skip that fires, the later draws go unread)
        g.set_state(state)
        draws = {}
        if kw.get("skip_percentage", 0) > 0:
            draws["skip"] = torch.rand((), generator=g, device=cuda)
        if mode == "range":
            draws["ratio"] = 0.25 + (0.75 - 0.25) * torch.rand(
                (), generator=g, device=cuda)
        draws["noise"] = torch.rand((3, 577), generator=g, device=cuda)
        want = tres.masked_drop(f, mode=mode, draws={
            k: v.cpu() for k, v in draws.items()}, **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["average", "max"])
@pytest.mark.parametrize("T,stride", [(16, 2), (25, 2), (36, 3)])
def test_spatial_pool(mode, T, stride):
    """max exact; the average within 1e-6 (XLA's reduce and PyTorch's mean
    add the window in other orders)."""
    f = _feats(5, T=T)
    np.testing.assert_allclose(
        tres.spatial_pool(torch.from_numpy(f), mode, stride).numpy(),
        np.asarray(jres.spatial_pool(jnp.asarray(f), mode, stride)),
        rtol=0, atol=0 if mode == "max" else 1e-6)
    with pytest.raises(ValueError, match="average or max"):
        tres.spatial_pool(torch.from_numpy(f), "conv")


def _perceiver(seed=0):
    return _moved(jres.init_perceiver(24, jax.random.PRNGKey(seed), depth=2,
                                      dim_head=8, heads=3, num_latents=6,
                                      ff_mult=2), seed)


def test_perceiver_f32():
    p = _perceiver()
    m = perceiver_from_jax(p, "cpu")
    assert m.heads == 3 and m.dim_head == 8 and len(m.layers) == 2
    f = _feats(6)
    assert _rel(m(torch.from_numpy(f)), jres.perceiver_resample(
        jax.tree.map(jnp.asarray, p), jnp.asarray(f))) < F32_TOL


def _qformer(seed=0, **kw):
    cfg = jqf.QformerConfig(**{**QCFG, **kw})
    return cfg, _moved(jqf.init_params(cfg, jax.random.PRNGKey(seed)), seed)


@pytest.mark.parametrize("freq", [1, 2, 3])
def test_qformer_f32(freq):
    cfg, p = _qformer(cross_attention_freq=freq)
    m = module_from_jax(tqf.Qformer(cfg, "meta"), p, "cpu")
    assert [layer.cross_attn is not None for layer in m.layers] == \
        ["cross" in lp for lp in p["layers"]]
    f = _feats(7)
    assert _rel(m(torch.from_numpy(f)), jqf.apply(
        jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(f))) < F32_TOL


def _flat(prefix, tree):
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        if hasattr(a, "shape"):
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(a,
                                                                  np.float32)
    return out


def test_resamplers_in_bf16_against_strict_jax(tmp_path):
    bf = lambda p: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(a).bfloat16().float().numpy()
        if hasattr(a, "shape") else a, p)
    qcfg, qp = _qformer(1)
    qp, pp = bf(qp), bf(_perceiver(1))
    f = _feats(8)
    inputs = {"f": f, **_flat("q", qp), **_flat("p", pp)}
    ref = strict_jax(f"""
import jax, jax.numpy as jnp, numpy as np
from lavida_mod_tpu.models import qformer as jqf, resampler as jres
def tree(prefix, like):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(IN[prefix + jax.tree_util.keystr(p)], jnp.bfloat16)
        if hasattr(a, "shape") else a for p, a in leaves])
cfg = jqf.QformerConfig(**{dataclasses_asdict(qcfg)!r})
qp = tree("q", jqf.init_params(cfg, jax.random.PRNGKey(0)))
pp = tree("p", jres.init_perceiver(24, jax.random.PRNGKey(0), depth=2,
                                   dim_head=8, heads=3, num_latents=6,
                                   ff_mult=2))
f = jnp.asarray(IN["f"], jnp.bfloat16)
OUT["q"] = np.asarray(jqf.apply(qp, cfg, f).astype(jnp.float32))
OUT["p"] = np.asarray(jres.perceiver_resample(pp, f).astype(jnp.float32))
""", tmp_path, inputs)
    tf = torch.from_numpy(f).bfloat16()
    with torch.no_grad():
        q = module_from_jax(tqf.Qformer(qcfg, "meta"), qp, "cpu",
                            torch.bfloat16)(tf)
        p = perceiver_from_jax(pp, "cpu", torch.bfloat16)(tf)
    assert q.dtype == p.dtype == torch.bfloat16
    assert _rel(q, ref["q"]) < BF16_TOL
    assert _rel(p, ref["p"]) < BF16_TOL


def dataclasses_asdict(cfg):
    return dataclasses.asdict(cfg)


def qformer_state(p, cfg):
    """Invert qformer.py:125-171."""
    st = {"query_tokens": p["query_tokens"][None]}
    ln = lambda pre, q: {f"{pre}.weight": q["weight"],  # noqa: E731
                         f"{pre}.bias": q["bias"]}
    lin = lambda pre, q: {f"{pre}.weight": q["kernel"].T,  # noqa: E731
                          f"{pre}.bias": q["bias"]}
    st.update(ln("Qformer.bert.embeddings.LayerNorm", p["emb_ln"]))
    st.update(ln("ln_vision", p["ln_vision"]))
    for i, lp in enumerate(p["layers"]):
        b = f"Qformer.bert.encoder.layer.{i}"
        for part, name in (("self", "attention"), ("cross",
                                                   "crossattention")):
            if part not in lp:
                continue
            a = lp[part]
            for ours, theirs in (("q", "self.query"), ("k", "self.key"),
                                 ("v", "self.value"),
                                 ("out", "output.dense")):
                st.update(lin(f"{b}.{name}.{theirs}", a[ours]))
            st.update(ln(f"{b}.{name}.output.LayerNorm", a["ln"]))
        st.update(lin(f"{b}.intermediate_query.dense", lp["ffn_q"]["fc1"]))
        st.update(lin(f"{b}.output_query.dense", lp["ffn_q"]["fc2"]))
        st.update(ln(f"{b}.output_query.LayerNorm", lp["ffn_q"]["ln"]))
    return {k: np.ascontiguousarray(v) for k, v in st.items()}


def test_convert_qformer_state_dict():
    cfg, p = _qformer(2)
    st = qformer_state(p, cfg)
    jp = jqf.convert_qformer_state_dict(st, cfg)
    flat = dict(jax.tree_util.tree_leaves_with_path(p))
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        np.testing.assert_array_equal(np.asarray(a), flat[path])
    m = tqf.convert_qformer_state_dict(st, cfg, device="cpu")
    want = module_state_from_jax(jax.tree.map(np.asarray, jp))
    got = m.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_qformer_config_equals_jax():
    assert [f.name for f in dataclasses.fields(QformerConfig)] == \
        [f.name for f in dataclasses.fields(jqf.QformerConfig)]
    assert dataclasses.asdict(QformerConfig()) == \
        dataclasses.asdict(jqf.QformerConfig())


@pytest.mark.parametrize("name,kw", [
    (None, {}), ("identity", {}), ("masked_drop", dict(mode="cls_only")),
    ("spatial_pool", dict(mode="max", stride=2)),
    ("perceiver", dict(depth=2, dim_head=8, heads=3, num_latents=5)),
    ("qformer", dict(depth=3, latents=6, num_hidden_layers=4,
                     hidden_size=32, num_attention_heads=4,
                     intermediate_size=64)),
    ("qformer", dict(num_latents=7, num_hidden_layers=2, hidden_size=32,
                     num_attention_heads=4, intermediate_size=64)),
])
def test_build_resampler_registry(name, kw):
    jp, fn = jres.build_resampler(name, dim=24, key=jax.random.PRNGKey(0),
                                  **dict(kw))
    m = tres.build_resampler(name, dim=24,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu", **dict(kw))
    f = _feats(9)
    want = np.asarray(fn(jp, jnp.asarray(f), training=False))
    got = m(torch.from_numpy(f), training=False)
    assert got.shape == want.shape
    if name == "qformer":
        # the reference's quirk: depth is the cross-attention frequency
        jcfg = jqf.QformerConfig(encoder_width=24, **{
            k: v for k, v in kw.items()
            if k not in ("depth", "latents", "num_latents")},
            num_query_tokens=kw.get("latents", kw.get("num_latents", 32)),
            cross_attention_freq=kw.get("depth", 2))
        assert dataclasses.asdict(m.cfg) == dataclasses.asdict(jcfg)
    if name in ("perceiver", "qformer"):
        # the same weights carried across compute JAX's output
        jm = (perceiver_from_jax(_np(jp), "cpu") if name == "perceiver"
              else module_from_jax(tqf.Qformer(m.cfg, "meta"), _np(jp),
                                   "cpu"))
        assert _rel(jm(torch.from_numpy(f)), want) < F32_TOL
        assert sorted(jm.state_dict()) == sorted(m.state_dict())
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a) if hasattr(a, "shape")
                        else a, tree)


def test_build_resampler_refuses():
    with pytest.raises(ValueError, match="unknown resampler"):
        tres.build_resampler("conv", device="cpu")
    with pytest.raises(ValueError, match="generator"):
        tres.build_resampler("perceiver", device="cpu")
