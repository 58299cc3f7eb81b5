"""The port's other vision towers (models/clip.py with S2, open_clip.py,
mlcd.py, eva_clip.py, tower_builder.py) and utils/debug.py against the JAX
package's, on the CPU at tiny widths (3 layers, width 32 or 64, 56 x 56
images, patch 14).

Weights are JAX's `init_params`, every leaf moved by seeded noise (so a
swapped norm, bias or table shows), carried over by
convert.module_from_jax.  Tolerances, as max |port - JAX| / max |JAX|:
  - f32: 1e-5 (the port and XLA sum in other orders; read 3e-7 - 1e-6);
  - bf16, the JAX side in a child process with XLA's excess precision off
    and its vision attention through the Pallas kernel in interpret mode
    (tests/torch_jax_strict.py), as the TPU runs it: 1e-2.  Every op
    rounds as JAX's does (the products before the bias, jax.nn's sigmoid
    and GELU op orders); read: every tower bit-equal, S2 5.9e-4 (its f32
    resizes sum in another order).  PyTorch's CPU bf16 matmul can sum in
    another order than XLA's (one bf16 ulp in a few thousand elements of
    a layer whose activations are large), hence the margin.
S2 is compared at two largest scales, and its antialiased image resize
alone on generated sizes.  The weight converters are held to JAX's on
synthetic reference-named state dicts (JAX's converters inverted):
bit-equal in f32.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.models import clip as jclip
from lavida_mod_tpu.models import eva_clip as jeva
from lavida_mod_tpu.models import mlcd as jmlcd
from lavida_mod_tpu.models import open_clip as joc
from lavida_mod_tpu.models import tower_builder as jtb
from lavida_mod_tpu.utils import debug as jdebug
from lavida_mod_tpu_torch.convert import module_from_jax, \
    module_state_from_jax
from lavida_mod_tpu_torch.models import clip as tclip
from lavida_mod_tpu_torch.models import eva_clip as teva
from lavida_mod_tpu_torch.models import mlcd as tmlcd
from lavida_mod_tpu_torch.models import open_clip as toc
from lavida_mod_tpu_torch.models import tower_builder as ttb
from lavida_mod_tpu_torch.models.siglip import SigLIP
from lavida_mod_tpu_torch.utils import debug as tdebug
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

GEO = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
           num_attention_heads=2, image_size=56, patch_size=14)
F32_TOL, BF16_TOL = 1e-5, 1e-2


def _moved(params, seed):
    """Every array leaf + 0.02 N(0, 1), numpy f32."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: None if a is None else (
            np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))
        ).astype(np.float32), params, is_leaf=lambda a: a is None)


def _pix(seed, n=3, size=56):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def _rel(t, j):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.abs(t - j).max() / np.abs(j).max())


def _clip(seed=0, **kw):
    cfg = jclip.clip_vit_l_config(**{**GEO, **kw})
    return cfg, _moved(jclip.init_params(cfg, jax.random.PRNGKey(seed)),
                       seed)


def _jax(fn, params, cfg, pix, **kw):
    p = jax.tree.map(jnp.asarray, params)
    return np.asarray(fn(p, cfg, jnp.asarray(pix), **kw))


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("select_layer,select_feature", [
    (-2, "patch"), (-1, "cls_patch"), (1, "patch")])
def test_clip(hidden_act, select_layer, select_feature):
    cfg, p = _clip(hidden_act=hidden_act)
    m = module_from_jax(tclip.CLIP(cfg, "meta"), p, "cpu")
    pix = _pix(1)
    kw = dict(select_layer=select_layer, select_feature=select_feature)
    assert _rel(m(torch.from_numpy(pix), **kw),
                _jax(jclip.forward, p, cfg, pix, **kw)) < F32_TOL


@pytest.mark.parametrize("s_max,scales", [(112, (56, 112)),
                                          (168, (56, 112, 168))])
def test_s2(s_max, scales):
    cfg, p = _clip()
    m = module_from_jax(tclip.CLIP(cfg, "meta"), p, "cpu")
    pix = _pix(2, n=2, size=s_max)
    got = tclip.S2(m, scales)(torch.from_numpy(pix))
    want = _jax(jclip.s2_forward, p, cfg, pix, scales=scales)
    assert got.shape == (2, 16, 32 * len(scales))
    assert _rel(got, want) < F32_TOL


@pytest.mark.parametrize("n_in,n_out", [(1008, 336), (1008, 672), (96, 32),
                                        (97, 41), (40, 56), (56, 56)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_images_as_jax(n_in, n_out, dtype):
    """S2's image resize: jax.image.resize's antialiased bilinear rule on
    generated sizes (shrinks by 3, 1.5 and odd factors, a stretch, none).
    The weights' normalising sums are added in another order than XLA's
    reduce, one f32 ulp apart at some sizes."""
    rng = np.random.default_rng(n_in + n_out)
    x = rng.uniform(-1, 1, (1, 3, n_in, n_in)).astype(np.float32)
    j = np.asarray(jclip._resize_images(
        jnp.asarray(x, getattr(jnp, dtype)), n_out).astype(jnp.float32))
    t = tclip._resize_images(torch.from_numpy(x).to(getattr(torch, dtype)),
                             n_out).float().numpy()
    assert t.shape == j.shape
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert np.abs(t - j).max() <= tol


def test_open_clip():
    cfg = joc.open_clip_vit_h14_378_config(**GEO)
    p = _moved(jclip.init_params(cfg, jax.random.PRNGKey(3)), 3)
    m = module_from_jax(tclip.CLIP(cfg, "meta"), p, "cpu")
    pix = _pix(3)
    assert _rel(m(torch.from_numpy(pix)),
                _jax(joc.forward, p, cfg, pix)) < F32_TOL


def test_imagebind_has_no_pre_ln():
    """No ln_pre (the module has none), the final layer's patch tokens,
    the tanh GELU for hidden_act "gelu" (clip.py:115-117)."""
    cfg = joc.imagebind_huge_vision_config(**GEO)
    p = _moved(jclip.init_params(cfg, jax.random.PRNGKey(4)), 4)
    p["pre_ln"] = None
    m = module_from_jax(toc.ImageBind(cfg, "meta"), p, "cpu")
    assert m.pre_ln is None and m.select_layer == -1
    pix = _pix(4)
    got = m(torch.from_numpy(pix))
    assert got.shape == (3, 16, 32)
    assert _rel(got, _jax(joc.imagebind_forward, p, cfg, pix)) < F32_TOL


def test_mlcd():
    cfg = jmlcd.mlcd_vit_l_config(**GEO)
    p = _moved(jmlcd.init_params(cfg, jax.random.PRNGKey(5)), 5)
    m = module_from_jax(tmlcd.MLCD(cfg, "meta"), p, "cpu")
    np.testing.assert_array_equal(tmlcd.rope_phase_table(cfg, 4, 3),
                                  jmlcd.rope_phase_table(cfg, 4, 3))
    pix = _pix(5)
    for kw in ({}, dict(select_layer=-1, select_feature="cls_patch")):
        assert _rel(m(torch.from_numpy(pix), **kw),
                    _jax(jmlcd.forward, p, cfg, pix, **kw)) < F32_TOL


EVA_FLAGS = [dict(), dict(rope=True), dict(subln=True),
             dict(naiveswiglu=True), dict(naiveswiglu=True, subln=True),
             dict(postnorm=True), dict(ls_init_value=0.1),
             dict(qkv_bias=False),
             dict(rope=True, subln=True, naiveswiglu=True, postnorm=True,
                  ls_init_value=0.5)]


@pytest.mark.parametrize("flags", EVA_FLAGS, ids=lambda f: "-".join(f)
                         or "plain")
def test_eva(flags):
    cfg = jeva.tiny_eva_config(**flags)
    p = _moved(jeva.init_params(cfg, jax.random.PRNGKey(6)), 6)
    m = module_from_jax(teva.EVAVisionTransformer(cfg, "meta"), p, "cpu")
    pix = _pix(6)
    for kw in ({}, dict(n_layers=cfg.layers)):
        assert _rel(m(torch.from_numpy(pix), **kw),
                    _jax(jeva.forward, p, cfg, pix, **kw)) < F32_TOL


def test_eva_rope_tables_equal_jax():
    cfg = jeva.tiny_eva_config(rope=True, image_size=70)
    for a, b in zip(teva._vision_rope_tables(cfg),
                    jeva._vision_rope_tables(cfg)):
        np.testing.assert_array_equal(a, b)


# -- bf16, JAX in the strict child --------------------------------------------

_BF16_JAX = """
import jax, jax.numpy as jnp, numpy as np
from lavida_mod_tpu.models import clip as jclip, eva_clip as jeva
from lavida_mod_tpu.models import mlcd as jmlcd, open_clip as joc
from lavida_mod_tpu.ops.short_attention import short_attention

# the vision attention as the TPU runs it: the Pallas kernel
att = lambda q, k, v, mesh=None: short_attention(q, k, v, interpret=True)
jclip.vision_attention = jmlcd.vision_attention = att
jeva.vision_attention = att


def tree(prefix):
    out = {}
    for key, a in IN.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key.split("/")[1:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(a, jnp.bfloat16)
    def lists(n):
        if isinstance(n, dict) and n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()} if isinstance(n, dict) \\
            else n
    return lists(out)


def run(name, fn, cfg, pix, **kw):
    OUT[name] = np.asarray(fn(tree(name), cfg, jnp.asarray(pix), **kw)
                           .astype(jnp.float32))
"""


def _flat(prefix, params):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is not None:
            out["/".join((prefix,) + path)] = np.asarray(node, np.float32)

    walk(params, ())
    return out


def _bf16(params):
    """f32 leaves rounded to bf16 values (kept f32: exact either way)."""
    return jax.tree.map(
        lambda a: None if a is None else torch.from_numpy(a).bfloat16()
        .float().numpy(), params, is_leaf=lambda a: a is None)


def test_towers_in_bf16_against_strict_jax(tmp_path):
    towers = {}
    cfg, p = _clip(seed=7, hidden_size=64, intermediate_size=128,
                   num_attention_heads=4)
    towers["clip"] = (cfg, _bf16(p), tclip.CLIP, "jclip.forward", "")
    towers["s2"] = (cfg, towers["clip"][1], tclip.CLIP, "jclip.s2_forward",
                    "scales=(56, 112, 168)")
    icfg = joc.imagebind_huge_vision_config(**GEO)
    ip = _moved(jclip.init_params(icfg, jax.random.PRNGKey(8)), 8)
    ip["pre_ln"] = None
    towers["imagebind"] = (icfg, _bf16(ip), toc.ImageBind,
                           "joc.imagebind_forward", "")
    mcfg = jmlcd.mlcd_vit_l_config(**GEO)
    towers["mlcd"] = (mcfg, _bf16(_moved(jmlcd.init_params(
        mcfg, jax.random.PRNGKey(9)), 9)), tmlcd.MLCD, "jmlcd.forward", "")
    for i, flags in enumerate((dict(), dict(rope=True, subln=True,
                                             naiveswiglu=True),
                               dict(postnorm=True, ls_init_value=0.5))):
        ecfg = jeva.tiny_eva_config(**flags)
        towers[f"eva{i}"] = (ecfg, _bf16(_moved(jeva.init_params(
            ecfg, jax.random.PRNGKey(10 + i)), 10 + i)),
            teva.EVAVisionTransformer, "jeva.forward", "")
    pix, pix2 = _pix(11), _pix(12, n=2, size=168)
    inputs = {"pix": pix, "pix2": pix2}
    code = [_BF16_JAX]
    for name, (cfg, p, _, fn, kw) in towers.items():
        inputs.update(_flat(name, p))
        mod = "jeva" if fn.startswith("jeva") else "jclip"
        ctor = (f"{mod}.{type(cfg).__name__}" if mod == "jeva" else
                "jclip.SigLIPConfig")
        code.append(f"run({name!r}, {fn}, {ctor}(**{_cfg_kw(cfg)!r}), "
                    f"IN[{'pix2' if name == 's2' else 'pix'!r}], {kw})")
    ref = strict_jax("\n".join(code), tmp_path, inputs)
    for name, (cfg, p, cls, *_) in towers.items():
        m = module_from_jax(cls(cfg, "meta"), p, "cpu", torch.bfloat16)
        with torch.no_grad():
            if name == "s2":
                got = tclip.s2_forward(m, torch.from_numpy(pix2),
                                       (56, 112, 168))
            else:
                got = m(torch.from_numpy(pix))
        assert got.dtype == (torch.float32 if name == "s2"
                             else torch.bfloat16)
        assert _rel(got, ref[name]) < BF16_TOL, name


def _cfg_kw(cfg):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# -- converters on reference-named state dicts --------------------------------

_CLIP_NAMES = {"ln1": "layer_norm1", "ln2": "layer_norm2",
               "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
               "v_proj": "self_attn.v_proj",
               "out_proj": "self_attn.out_proj", "fc1": "mlp.fc1",
               "fc2": "mlp.fc2"}


def _linear_leaves(p):
    return {("weight" if k in ("kernel", "weight") else k):
            (v.T if k == "kernel" else v) for k, v in p.items()}


def clip_state(p, cfg, prefix="vision_model.", mlcd=False):
    """Invert clip.py:196-243 (mlcd.py:152-174 with mlcd)."""
    D, C, P = cfg.hidden_size, cfg.num_channels, cfg.patch_size
    st = {"embeddings.class_embedding": p["class_embed"],
          "embeddings.patch_embedding.weight":
              p["patch_embed"]["kernel"].T.reshape(D, C, P, P),
          "pre_layrnorm.weight": p["pre_ln"]["weight"],
          "pre_layrnorm.bias": p["pre_ln"]["bias"],
          "post_layernorm.weight": np.ones(D, np.float32)}  # never read
    if mlcd:
        st["class_pos_emb"] = p["class_pos_emb"]
    else:
        st["embeddings.position_embedding.weight"] = p["pos_embed"]
    for mod, leaves in p["layers"].items():
        for i in range(cfg.num_hidden_layers):
            for leaf, a in _linear_leaves({k: v[i] for k, v in
                                           leaves.items()}).items():
                st[f"encoder.layers.{i}.{_CLIP_NAMES[mod]}.{leaf}"] = a
    return {prefix + k: np.ascontiguousarray(v) for k, v in st.items()}


def _fused_state(p, cfg, block, names):
    """open_clip / imagebind layers: q / k / v fused into in_proj."""
    st = {}
    L = p["layers"]
    for i in range(cfg.num_hidden_layers):
        lt = block.format(i)
        st[lt + "attn.in_proj_weight"] = np.concatenate(
            [L[m]["kernel"][i].T for m in ("q_proj", "k_proj", "v_proj")])
        st[lt + "attn.in_proj_bias"] = np.concatenate(
            [L[m]["bias"][i] for m in ("q_proj", "k_proj", "v_proj")])
        for ours, theirs in names.items():
            for leaf, a in _linear_leaves({k: v[i] for k, v in
                                           L[ours].items()}).items():
                st[f"{lt}{theirs}.{leaf}"] = a
    return st


def open_clip_state(p, cfg):
    D, C, P = cfg.hidden_size, cfg.num_channels, cfg.patch_size
    st = _fused_state(p, cfg, "transformer.resblocks.{}.",
                      {"out_proj": "attn.out_proj", "fc1": "mlp.c_fc",
                       "fc2": "mlp.c_proj", "ln1": "ln_1", "ln2": "ln_2"})
    st.update({"conv1.weight": p["patch_embed"]["kernel"].T.reshape(
                   D, C, P, P),
               "class_embedding": p["class_embed"],
               "positional_embedding": p["pos_embed"],
               "ln_pre.weight": p["pre_ln"]["weight"],
               "ln_pre.bias": p["pre_ln"]["bias"]})
    return {"visual." + k: np.ascontiguousarray(v) for k, v in st.items()}


def imagebind_state(p, cfg):
    D, C, P = cfg.hidden_size, cfg.num_channels, cfg.patch_size
    pre = "modality_preprocessors.vision."
    st = _fused_state(p, cfg, "modality_trunks.vision.blocks.{}.",
                      {"out_proj": "attn.out_proj", "fc1": "mlp.fc1",
                       "fc2": "mlp.fc2", "ln1": "norm_1", "ln2": "norm_2"})
    st.update({pre + "rgbt_stem.proj.weight":
               p["patch_embed"]["kernel"].T.reshape(D, C, 1, P, P),
               pre + "cls_token": p["class_embed"].reshape(1, 1, D),
               pre + "pos_embedding_helper.pos_embed": p["pos_embed"][None]})
    return {k: np.ascontiguousarray(v) for k, v in st.items()}


_EVA_NAMES = {"norm1": "norm1", "norm2": "norm2", "proj": "attn.proj",
              "q_proj": "attn.q_proj", "k_proj": "attn.k_proj",
              "v_proj": "attn.v_proj", "inner_ln": "attn.inner_attn_ln",
              "qkv": "attn.qkv", "w1": "mlp.w1", "w2": "mlp.w2",
              "w3": "mlp.w3", "ffn_ln": "mlp.ffn_ln", "fc1": "mlp.fc1",
              "fc2": "mlp.fc2", "q_bias": "attn.q_bias",
              "v_bias": "attn.v_bias", "gamma_1": "gamma_1",
              "gamma_2": "gamma_2"}


def eva_state(p, cfg, prefix="visual."):
    """Invert eva_clip.py:286-352."""
    D, P = cfg.width, cfg.patch_size
    st = {"patch_embed.proj.weight": p["patch_embed"]["kernel"].T.reshape(
              D, 3, P, P),
          "patch_embed.proj.bias": p["patch_embed"]["bias"],
          "cls_token": p["cls_token"].reshape(1, 1, D),
          "pos_embed": p["pos_embed"][None]}
    for i, layer in enumerate(p["layers"]):
        for mod, v in layer.items():
            name = f"blocks.{i}.{_EVA_NAMES[mod]}"
            if isinstance(v, dict):
                for leaf, a in _linear_leaves(v).items():
                    st[f"{name}.{leaf}"] = a
            else:
                st[name] = v
    return {prefix + k: np.ascontiguousarray(v) for k, v in st.items()}


def _equal(module, params):
    want = module_state_from_jax(jax.tree.map(np.asarray, params))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _inverts(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_array_equal(np.asarray(a), flat_want[path])


def test_convert_clip_state_dict():
    cfg, p = _clip()
    st = clip_state(p, cfg)
    jp = jclip.convert_clip_state_dict(st, cfg, jnp.float32)
    _inverts(jp, p)
    _equal(tclip.convert_clip_state_dict(st, cfg, torch.float32,
                                         device="cpu"), jp)
    # bf16, as both converters default to
    _equal(tclip.convert_clip_state_dict(st, cfg, device="cpu"),
           jclip.convert_clip_state_dict(st, cfg))


def test_convert_mlcd_state_dict():
    cfg = jmlcd.mlcd_vit_l_config(**GEO)
    p = _moved(jmlcd.init_params(cfg, jax.random.PRNGKey(5)), 5)
    st = clip_state(p, cfg, mlcd=True)
    jp = jmlcd.convert_mlcd_state_dict(st, cfg, jnp.float32)
    _inverts(jp, p)
    _equal(tmlcd.convert_mlcd_state_dict(st, cfg, torch.float32,
                                         device="cpu"), jp)
    st.pop("vision_model.class_pos_emb")
    with pytest.raises(KeyError, match="class_pos_emb"):
        tmlcd.convert_mlcd_state_dict(st, cfg, device="cpu")


def test_convert_open_clip_and_imagebind():
    cfg = joc.open_clip_vit_h14_378_config(**GEO)
    p = _moved(jclip.init_params(cfg, jax.random.PRNGKey(3)), 3)
    st = open_clip_state(p, cfg)
    jp = joc.convert_open_clip_visual(st, cfg, jnp.float32)
    _inverts(jp, p)
    _equal(toc.convert_open_clip_visual(st, cfg, torch.float32,
                                        device="cpu"), jp)
    icfg = joc.imagebind_huge_vision_config(**GEO)
    ip = _moved(jclip.init_params(icfg, jax.random.PRNGKey(4)), 4)
    ist = imagebind_state(ip, icfg)
    jip = joc.convert_imagebind_vision(ist, icfg, jnp.float32)
    assert jip["pre_ln"] is None
    _equal(toc.convert_imagebind_vision(ist, icfg, torch.float32,
                                        device="cpu"), jip)


@pytest.mark.parametrize("flags", EVA_FLAGS, ids=lambda f: "-".join(f)
                         or "plain")
def test_convert_eva_state_dict(flags):
    cfg = jeva.tiny_eva_config(**flags)
    p = _moved(jeva.init_params(cfg, jax.random.PRNGKey(6)), 6)
    st = eva_state(p, cfg)
    jp = jeva.convert_eva_state_dict(st, cfg, prefix="visual.")
    _inverts(jp, p)
    _equal(teva.convert_eva_state_dict(st, cfg, prefix="visual.",
                                       device="cpu"), jp)


# -- the registry -------------------------------------------------------------

NAMES = ["siglip", "google/siglip-so400m-patch14-384", "mlcd-vit-l",
         "open_clip_hub", "imagebind_huge", "eva-clip-8b", "EVA02-CLIP",
         "openai/clip-vit-large-patch14-336", "clip-s2",
         "siglip_mlcd", "open_clip_eva", "my_clip_imagebind"]

_KINDS = {jclip.forward: tclip.CLIP, jclip.s2_forward: tclip.S2,
          jmlcd.forward: tmlcd.MLCD, joc.imagebind_forward: toc.ImageBind,
          jeva.forward: teva.EVAVisionTransformer}


def _kind(fn):
    from lavida_mod_tpu.models import siglip as jsig

    return SigLIP if fn is jsig.forward else _KINDS[fn]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("s2", [False, True])
def test_build_vision_tower_dispatch(name, s2):
    jcfg, fn = jtb.build_vision_tower(name, s2=s2)
    tcfg, module = ttb.build_vision_tower(name, device="meta", s2=s2)
    assert type(module) is _kind(fn)
    assert _cfg_kw(tcfg) == _cfg_kw(jcfg)
    assert module.cfg == tcfg


def test_build_vision_tower_takes_a_config_and_draws_weights():
    cfg = jclip.clip_vit_l_config(**GEO)
    tcfg, m = ttb.build_vision_tower(
        "clip", device="cpu", dtype=torch.float32, cfg=cfg,
        generator=torch.Generator().manual_seed(3))
    assert tcfg is cfg and m.layers[0].ln1.weight.eq(1).all()
    std = float(m.layers[0].q_proj.weight.detach().std())
    assert 0.015 < std < 0.025 and not m.layers[0].q_proj.bias.any()
    again = ttb.build_vision_tower("clip", device="cpu", dtype=torch.float32,
                                   cfg=cfg, generator=torch.Generator()
                                   .manual_seed(3))[1]
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 again.state_dict().values()))
    out = m(torch.from_numpy(_pix(0)))
    assert out.shape == (3, 16, 32) and torch.isfinite(out).all()


def test_unknown_tower_raises_as_jax():
    with pytest.raises(ValueError) as j:
        jtb.build_vision_tower("resnet50")
    with pytest.raises(ValueError) as t:
        ttb.build_vision_tower("resnet50", device="meta")
    assert str(t.value) == str(j.value)


HF_TYPES = ["clip_vision_model", "clip", "siglip_vision_model", "siglip",
            "mlcd_vision_model"]


@pytest.mark.parametrize("model_type", HF_TYPES)
@pytest.mark.parametrize("nested", [False, True])
def test_hf_vision_tower(tmp_path, model_type, nested):
    geo = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
               num_attention_heads=3, image_size=42, patch_size=14,
               layer_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
               model_type=model_type, projection_dim=7)
    cj = {"model_type": "other", "vision_config": geo} if nested else geo
    (tmp_path / "config.json").write_text(json.dumps(cj))
    for name in (f"hf:{tmp_path}", f"HF-{tmp_path}"):
        jcfg, fn = jtb.build_vision_tower(name)
        tcfg, m = ttb.build_vision_tower(name, device="meta")
        assert _cfg_kw(tcfg) == _cfg_kw(jcfg)
        assert type(m) is _kind(fn)
    jcfg, fn = jtb.hf_vision_tower(model_type)
    tcfg, m = ttb.hf_vision_tower(model_type, device="meta")
    assert _cfg_kw(tcfg) == _cfg_kw(jcfg) and type(m) is _kind(fn)


@pytest.mark.parametrize("model_type", ["dinov2", ""])
def test_hf_vision_tower_refuses_as_jax(tmp_path, model_type):
    (tmp_path / "config.json").write_text(json.dumps(
        {"vision_config": {"model_type": model_type}}))
    for arg in (str(tmp_path), "dinov2"):
        with pytest.raises(NotImplementedError) as j:
            jtb.hf_vision_tower(arg)
        with pytest.raises(NotImplementedError) as t:
            ttb.hf_vision_tower(arg, device="meta")
        assert str(t.value) == str(j.value)


# -- utils/debug.py -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_debug_utils_as_jax(dtype):
    x = np.array([[0.5, -np.inf, np.nan, np.inf], [1e30, -2.0, 0.0, -1e-3]],
                 np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    for kw in ({}, {"neg_inf": -5.0}):
        got = tdebug.ensure_finite(tx, **kw)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jdebug.ensure_finite(jx, **kw).astype(jnp.float32)))
    tree = {"a": [tx, torch.ones(3)], "b": (torch.arange(4),),
            "c": {"d": tx[0]}}
    jtree = {"a": [jx, jnp.ones(3)], "b": (jnp.arange(4),),
             "c": {"d": jx[0]}}
    assert int(tdebug.count_nonfinite(tree)) == int(
        jdebug.count_nonfinite(jtree)) == 6
    assert int(tdebug.count_nonfinite({})) == int(
        jdebug.count_nonfinite({})) == 0
    with pytest.raises(AssertionError, match="x contains 6 non-finite"):
        tdebug.assert_all_finite(tree, "x")
    tdebug.assert_all_finite(torch.nn.Linear(2, 2))
    tdebug.assert_all_finite({"ok": torch.ones(2)})


@pytest.mark.parametrize("kind", ["clip", "imagebind", "mlcd", "eva",
                                  "eva_subln_rope", "eva_bias"])
def test_towers_hand_the_kernel_contiguous_operands(kind, monkeypatch):
    """The kernel refuses strided q / k / v (the CPU's plain version takes
    them): every tower must hand `vision_attention` contiguous operands,
    the fused qkv's thirds included."""
    seen, plain = [], tclip.vision_attention

    def attention(q, k, v):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return plain(q, k, v)

    for mod in (tclip, tmlcd, teva):
        monkeypatch.setattr(mod, "vision_attention", attention)
    if kind.startswith("eva"):
        flags = {"eva": dict(qkv_bias=False), "eva_bias": {},
                 "eva_subln_rope": dict(subln=True, rope=True)}[kind]
        cfg = jeva.tiny_eva_config(**flags)
        m = teva.EVAVisionTransformer(cfg, "cpu")
    else:
        cls = {"clip": tclip.CLIP, "imagebind": toc.ImageBind,
               "mlcd": tmlcd.MLCD}[kind]
        m = cls(jclip.clip_vit_l_config(**GEO), "cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        m(torch.from_numpy(_pix(0)))
    assert seen and all(seen)
