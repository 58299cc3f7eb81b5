"""The port's projector kinds (models/projector.py) against the JAX
package's, on the CPU at tiny widths.

  - every kind's forward ("linear", "identity", "pooler", "mlp{N}x_gelu",
    "mlp{N}x_res{M}x_gelu") with JAX's init_params weights moved by seeded
    noise: f32 within 1e-6 of max |JAX|, bf16 with JAX in the strict child
    (tests/torch_jax_strict.py) bit-equal (the products rounded before
    the bias, as JAX's `h @ kernel + bias`);
  - `port_name` of each kind's reference names, `parse_projector_type`,
    and `_bilinear_no_antialias` (S2's grid resize) on several sizes;
  - `LaViDa.load` of a tiny reference-layout checkpoint whose config.json
    names each kind: the state dict bit-equal to `from_jax` of JAX's
    `LaViDa.load`, and one bf16 generation per kind teacher-forced against
    JAX's steps (`torch_jax_strict.teacher_forced`), from JAX's prefix, the
    port's own prefix within 1 % of JAX's;
  - the JAX behaviours the port mirrors (ROADMAP Queue 3): a loaded res
    projector runs without its residual blocks (JAX's converter reads
    none), and the pooler refuses SigLIP's 27 x 27 grid (its ratio 2 does
    not divide it).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import projector as jproj
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu.ops import pooling as jpool
from lavida_mod_tpu_torch.config import GenerationConfig
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.models import projector as tproj
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.ops import pooling as tpool
from test_torch_checkpoint import (_config_json, _params, _save_shards,
                                   reference_state)
from torch_jax_strict import JAX_STEPS, strict_jax, teacher_forced

torch.set_num_threads(2)

KINDS = ["linear", "identity", "pooler", "mlp2x_gelu", "mlp3x_gelu",
         "mlp2x_res2x_gelu", "mlp1x_res1x_gelu"]


def _moved(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a))).astype(np.float32), params)


def _widths(kind):
    return (32, 32) if kind == "identity" else (24, 32)


def _port(kind, p, dtype=None):
    mm, hidden = _widths(kind)
    m = tproj.Projector(kind, mm, hidden, "meta")
    state = state_dict_from_jax({"projector": p})
    m.load_state_dict({k[len("projector."):]: v for k, v in state.items()},
                      strict=True, assign=True)
    if dtype is not None:
        m.to(dtype)
    return m


def _jax_params(kind, seed=0):
    mm, hidden = _widths(kind)
    return _moved(jproj.init_params(kind, mm, hidden,
                                    jax.random.PRNGKey(seed)), seed)


def test_parse_projector_type_equals_jax():
    for kind in KINDS + ["mlp12x_res3x_gelu"]:
        assert tproj.parse_projector_type(kind) == \
            jproj.parse_projector_type(kind)
    for bad in ("mlp2x_relu", "conv", "mlpx_gelu"):
        with pytest.raises(ValueError) as j:
            jproj.parse_projector_type(bad)
        with pytest.raises(ValueError) as t:
            tproj.parse_projector_type(bad)
        assert str(t.value) == str(j.value)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_f32(kind):
    p = _jax_params(kind)
    x = np.random.default_rng(1).standard_normal(
        (3, 16, _widths(kind)[0])).astype(np.float32)
    want = np.asarray(jproj.forward(jax.tree.map(jnp.asarray, p), kind,
                                    jnp.asarray(x)))
    got = _port(kind, p)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_forward_bf16_against_strict_jax(tmp_path):
    inputs, params = {}, {}
    rng = np.random.default_rng(2)
    for i, kind in enumerate(KINDS):
        p = jax.tree.map(lambda a: torch.from_numpy(a).bfloat16().float()
                         .numpy(), _jax_params(kind, i))
        params[kind] = p
        for path, a in jax.tree_util.tree_leaves_with_path(p):
            inputs[kind + jax.tree_util.keystr(path)] = a
        inputs[kind + "/x"] = rng.standard_normal(
            (2, 16, _widths(kind)[0])).astype(np.float32)
    ref = strict_jax(f"""
import jax, jax.numpy as jnp, numpy as np
from lavida_mod_tpu.models import projector as jproj
for kind in {KINDS!r}:
    mm, hidden = (32, 32) if kind == "identity" else (24, 32)
    like = jproj.init_params(kind, mm, hidden, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    p = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(IN[kind + jax.tree_util.keystr(k)], jnp.bfloat16)
        for k, _ in leaves])
    x = jnp.asarray(IN[kind + "/x"], jnp.bfloat16)
    OUT[kind] = np.asarray(jproj.forward(p, kind, x).astype(jnp.float32))
""", tmp_path, inputs)
    for kind in KINDS:
        with torch.no_grad():
            got = _port(kind, params[kind], torch.bfloat16)(
                torch.from_numpy(inputs[kind + "/x"]).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), ref[kind],
                                      err_msg=kind)


def test_pooler_refuses_siglips_grid_as_jax():
    """SigLIP so400m's 27 x 27 grid: JAX asserts, the port raises."""
    p = _jax_params("pooler")
    x = np.zeros((1, 27 * 27, 24), np.float32)
    with pytest.raises(AssertionError, match="divisible"):
        jproj.forward(jax.tree.map(jnp.asarray, p), "pooler", jnp.asarray(x))
    with pytest.raises(ValueError, match="divisible"):
        _port("pooler", p)(torch.from_numpy(x))


def test_identity_needs_the_lm_width():
    with pytest.raises(ValueError, match="identity projector"):
        tproj.Projector("identity", 24, 32, "cpu")
    assert not list(tproj.Projector("identity", 32, 32, "cpu").parameters())


REFERENCE_NAMES = {
    "linear": {"weight": "layers.0.weight", "bias": "layers.0.bias"},
    "pooler": {"conv_pool.weight": "conv.weight",
               "conv_pool.bias": "conv.bias",
               "proj.1.weight": "proj.weight", "proj.1.bias": "proj.bias"},
    "mlp3x_gelu": {"0.weight": "layers.0.weight", "2.bias": "layers.1.bias",
                   "4.weight": "layers.2.weight"},
    "mlp2x_res2x_gelu": {"0.weight": "layers.0.weight",
                         "2.bias": "layers.1.bias",
                         "3.pre_norm.weight": None, "3.proj.0.weight": None,
                         "4.proj.2.bias": None},
}


@pytest.mark.parametrize("kind", sorted(REFERENCE_NAMES))
def test_port_name(kind):
    for name, want in REFERENCE_NAMES[kind].items():
        assert tproj.port_name(name, kind) == want
    bad = ["1.weight", "weight.x", "6.weight", "5.pre_norm.weight",
           "conv_pool.bias2"]
    for name in bad + (["weight"] if kind != "linear" else []):
        with pytest.raises(ValueError, match="no weight"):
            tproj.port_name(name, kind)
    with pytest.raises(ValueError, match="no weight"):
        tproj.port_name("0.weight", "identity")


@pytest.mark.parametrize("g,go", [(27, 14), (54, 27), (8, 3), (5, 9),
                                  (12, 12)])
def test_bilinear_no_antialias_as_jax(g, go):
    x = np.random.default_rng(g).standard_normal((2, g, g, 5)).astype(
        np.float32)
    want = np.asarray(jpool._bilinear_no_antialias(jnp.asarray(x), go))
    got = tpool._bilinear_no_antialias(torch.from_numpy(x), go)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- checkpoints of each kind -------------------------------------------------

LOAD_KINDS = ["linear", "identity", "pooler", "mlp2x_res2x_gelu"]


def _cfg(kind):
    d = 64
    siglip = tiny_siglip_config(hidden_size=d if kind == "identity" else 32)
    return LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=siglip, projector_type=kind,
                            mm_hidden_size=siglip.hidden_size,
                            grid_pinpoints=((56, 112), (112, 56),
                                            (112, 112))))


def projector_state(p, kind, depth_res=None):
    """Invert projector.py:114-147: the reference names of each kind,
    the res kind's SimpleResBlocks too (which JAX's converter skips)."""
    st = {}
    if kind == "linear":
        st["weight"], st["bias"] = p["layers"][0]["kernel"].T, \
            p["layers"][0]["bias"]
    elif kind == "pooler":
        k = p["conv"]["kernel"]
        r = 2
        st["conv_pool.weight"] = k.T.reshape(k.shape[1], -1, r, r)
        st["conv_pool.bias"] = p["conv"]["bias"]
        st["proj.1.weight"] = p["proj"]["kernel"].T
        st["proj.1.bias"] = p["proj"]["bias"]
    elif kind != "identity":
        for j, layer in enumerate(p["layers"]):
            st[f"{2 * j}.weight"] = layer["kernel"].T
            st[f"{2 * j}.bias"] = layer["bias"]
        for j, rb in enumerate(p.get("res_blocks", [])):
            i = 2 * len(p["layers"]) - 1 + j
            st[f"{i}.pre_norm.weight"] = rb["pre_norm"]["weight"]
            st[f"{i}.pre_norm.bias"] = rb["pre_norm"]["bias"]
            for k, name in (("fc1", "proj.0"), ("fc2", "proj.2")):
                st[f"{i}.{name}.weight"] = rb[k]["kernel"].T
                st[f"{i}.{name}.bias"] = rb[k]["bias"]
    return {"model.mm_projector." + k: np.ascontiguousarray(v, np.float32)
            for k, v in st.items()}


def write_checkpoint(kind, path):
    cfg = _cfg(kind)
    params = _params(cfg)
    proj = params["projector"]
    state = reference_state({**params, "projector": {"layers": []}}, cfg)
    state.update(projector_state(proj, kind))
    _save_shards(state, path)
    with open(os.path.join(path, "config.json"), "w") as f:
        import json

        json.dump(_config_json(cfg), f)
    return cfg, params


@pytest.mark.parametrize("kind", LOAD_KINDS)
def test_load_equals_from_jax_of_jax_load(kind, tmp_path):
    path = str(tmp_path / kind)
    cfg, params = write_checkpoint(kind, path)
    jm = JLaViDa.load(path)
    assert jm.cfg.vision.projector_type == kind
    tm = LaViDa.load(path, device="cpu")
    want = LaViDa.from_jax(jm.cfg, jax.tree.map(np.asarray, jm.params),
                           "cpu")
    assert tm.cfg == want.cfg
    got, exp = tm.state_dict(), want.state_dict()
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert got[k].dtype == exp[k].dtype and torch.equal(got[k], exp[k]), k
    names = {k for k in got if k.startswith("projector.")}
    assert names == {"projector." + n for n in {
        "linear": ["layers.0.weight", "layers.0.bias"], "identity": [],
        "pooler": ["conv.weight", "conv.bias", "proj.weight", "proj.bias"],
        "mlp2x_res2x_gelu": ["layers.0.weight", "layers.0.bias",
                             "layers.1.weight", "layers.1.bias"]}[kind]}


def test_loaded_res_projector_runs_without_its_blocks(tmp_path):
    """JAX's converter returns the res kind's `layers` only
    (projector.py:139-147), so its forward skips the residual blocks that
    the checkpoint holds (forward :104 reads params.get("res_blocks", [])).
    The port mirrors it: the loaded projector is the plain mlp2x."""
    kind = "mlp2x_res2x_gelu"
    cfg, params = write_checkpoint(kind, str(tmp_path / "ckpt"))
    assert len(params["projector"]["res_blocks"]) == 2
    jm = JLaViDa.load(str(tmp_path / "ckpt"), dtype=jnp.float32)
    assert set(jm.params["projector"]) == {"layers"}
    tm = LaViDa.load(str(tmp_path / "ckpt"), dtype=torch.float32,
                     device="cpu")
    assert len(tm.projector.res_blocks) == 0
    x = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(
        np.float32)
    got = tm.projector(torch.from_numpy(x)).detach().numpy()
    plain = np.asarray(jproj.forward(jm.params["projector"], "mlp2x_gelu",
                                     jnp.asarray(x)))
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)
    blocks = np.asarray(jproj.forward(jax.tree.map(
        jnp.asarray, params["projector"]), kind, jnp.asarray(x)))
    assert np.abs(got - blocks).max() > 1e-2, "the blocks would act"


GEN = dict(max_new_tokens=16, block_length=16, step_per_block=8)


def test_generation_per_kind_teacher_forced(tmp_path):
    rng = np.random.default_rng(11)
    inputs = {}
    for i, kind in enumerate(LOAD_KINDS):
        write_checkpoint(kind, str(tmp_path / kind))
        inputs[f"ids{i}"] = np.concatenate(
            [rng.integers(3, 400, 3), [-200], rng.integers(3, 400, 5)])
        inputs[f"views{i}"] = rng.standard_normal((1, 3, 56, 56)).astype(
            np.float32)
    ref = strict_jax(JAX_STEPS + f"""
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.models.lavida import LaViDa
from lavida_mod_tpu.ops.short_attention import short_attention

jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
gen = GenerationConfig(**{GEN!r})
for i, kind in enumerate({LOAD_KINDS!r}):
    jm = LaViDa.load({str(tmp_path)!r} + "/" + kind)
    jm.params["llada"] = jl.unstack_blocks(jm.params["llada"])
    prefix = jm.encode_prompt(IN[f"ids{{i}}"], [IN[f"views{{i}}"]],
                              [(56, 56)])
    OUT[f"xs{{i}}"], OUT[f"logits{{i}}"] = jax_steps(
        jm.params["llada"], jm.cfg.llada, prefix, gen)
    OUT[f"prefix{{i}}"] = np.asarray(prefix.astype(jnp.float32))
""", tmp_path, inputs)
    gen = GenerationConfig(**GEN)
    for i, kind in enumerate(LOAD_KINDS):
        tm = LaViDa.load(str(tmp_path / kind), device="cpu")
        want = torch.from_numpy(ref[f"prefix{i}"])
        with torch.no_grad():
            prefix = tm.encode_prompt(inputs[f"ids{i}"], [inputs[f"views{i}"]],
                                      [(56, 56)]).float()
        assert prefix.shape == want.shape, kind
        assert (prefix - want).abs().max() <= 1e-2 * want.abs().max(), kind
        xs = ref[f"xs{i}"]
        assert len(set(xs[-1].ravel().tolist())) >= 3, "degenerate"
        teacher_forced(tm, want.bfloat16(), gen, xs, ref[f"logits{i}"])


def test_one_gather_splice_refuses_the_pooler(tmp_path):
    """The pooler halves each side of the grid, so a view gives fewer rows
    than the gather plan indexes: JAX's generate_fused runs on (its gather
    clamps the indices), the port's refuses; encode_prompt's splice takes
    the pooler's count (the generation test above)."""
    write_checkpoint("pooler", str(tmp_path / "p"))
    tm = LaViDa.load(str(tmp_path / "p"), device="cpu")
    ids = np.array([5, 6, -200, 7, 8])
    views = np.zeros((1, 3, 56, 56), np.float32)
    with pytest.raises(ValueError, match="pooler projector gives 1 tokens"):
        tm.generate_fused(ids, [views], [(56, 56)],
                          GenerationConfig(**GEN))
