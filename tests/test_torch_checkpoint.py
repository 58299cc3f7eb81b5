"""The port's checkpoint loading against the JAX package's, on files.

A reference-named state dict (the names of the published LaViDa weights:
model.transformer.*, model.vision_tower.vision_tower.vision_model.*,
model.mm_projector.*, model.image_newline) is made from the JAX package's
tiny `init_params` by inverting its converters: each kernel transposed to
[out, in], each stacked layer split under its reference name, the patch
kernel back to the conv's [D, C, p, p].  Every leaf is moved off its init
value by seeded noise (so a swapped norm or bias shows) and the LLaDA
matrices are scaled x10 (so the tiny model's tokens vary).  JAX's
`convert_lavida_state_dict` must give the params back, which proves the
helper without the reference code.

Then, on files in tmp_path, the port's `LaViDa.load(..., device="cpu")`
state dict must equal `LaViDa.from_jax` of the JAX `LaViDa.load` of the
same files, bit for bit, in every load mode and file format; the mixed
layout built after the load must equal the one `from_jax` makes of JAX's
load after its `to_serving_layout("mixed")`; and one bf16 generation
after the load must be token-exact with JAX's at temperature 0 (the JAX
side in a child process without XLA's excess precision,
tests/torch_jax_strict.py).  The port's safetensors reader and writer are
held to the `safetensors` package on every dtype.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import multimodal as jmm
from lavida_mod_tpu.models.dream import tiny_dream_config
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu.models.lavida import convert_lavida_state_dict
from lavida_mod_tpu_torch.models import llada_loader
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.tools import safetensors_io as sio
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
# every LLaDA width a multiple of 512, so the mixed layout is int4
WIDE = CFG.replace(llada=tiny_llada_config(
    d_model=512, n_heads=4, n_kv_heads=4, mlp_hidden_size=1024))
LM = "model.transformer."
VT = "model.vision_tower.vision_tower.vision_model."
SIGLIP_NAMES = {"ln1": "layer_norm1", "ln2": "layer_norm2",
                "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                "v_proj": "self_attn.v_proj",
                "out_proj": "self_attn.out_proj", "fc1": "mlp.fc1",
                "fc2": "mlp.fc2"}


def _params(cfg, seed=0):
    """JAX init_params, every leaf moved by seeded noise, the LLaDA
    matrices x10; numpy leaves."""
    p = jax.tree.map(np.asarray, jmm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape))
                     .astype(np.float32), p)
    p["llada"] = jax.tree.map(lambda a: a * 10.0 if a.ndim >= 2 else a,
                              p["llada"])
    return p


def reference_state(params, cfg) -> dict:
    """Invert JAX's converters: params -> reference-named numpy arrays
    (llada_loader.py:3-12, siglip.py:236-241, projector.py:139-147)."""
    st = {}
    lp = params["llada"]
    st[LM + "wte.weight"] = lp["wte"]
    st[LM + "ln_f.weight"] = lp["ln_f"]["weight"]
    st[LM + "ff_out.weight"] = lp["ff_out"]["kernel"].T
    for mod, leaves in lp["blocks"].items():
        for i in range(cfg.llada.n_layers):
            st[f"{LM}blocks.{i}.{mod}.weight"] = (
                leaves["kernel"][i].T if "kernel" in leaves
                else leaves["weight"][i])
    sp, sc = params["siglip"], cfg.vision.siglip
    D, C, P = sc.hidden_size, sc.num_channels, sc.patch_size
    st[VT + "embeddings.patch_embedding.weight"] = (
        sp["patch_embed"]["kernel"].T.reshape(D, C, P, P))
    st[VT + "embeddings.patch_embedding.bias"] = sp["patch_embed"]["bias"]
    st[VT + "embeddings.position_embedding.weight"] = sp["pos_embed"]
    for mod, leaves in sp["layers"].items():
        for i in range(sc.n_layers_used):
            for leaf, a in leaves.items():
                name = "weight" if leaf in ("kernel", "weight") else leaf
                st[f"{VT}encoder.layers.{i}.{SIGLIP_NAMES[mod]}.{name}"] = (
                    a[i].T if leaf == "kernel" else a[i])
    for j, layer in enumerate(params["projector"]["layers"]):
        st[f"model.mm_projector.{2 * j}.weight"] = layer["kernel"].T
        st[f"model.mm_projector.{2 * j}.bias"] = layer["bias"]
    st["model.image_newline"] = params["image_newline"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in st.items()}


# LaViDa-Dream: the tiny Dream LM (GQA, the QKV bias) with CFG's tower
DREAM = CFG.replace(llada=tiny_dream_config())
# the JAX Dream converter's names, inverted (models/dream.py:72-86)
DREAM_LINEARS = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                 "v_proj": "self_attn.v_proj", "attn_out": "self_attn.o_proj",
                 "ff_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
                 "ff_out": "mlp.down_proj", "attn_norm": "input_layernorm",
                 "ff_norm": "post_attention_layernorm"}


def dream_reference_state(params, cfg) -> dict:
    """A LaViDa-Dream checkpoint's HF names (modeling_dream.py: model.
    layers.N.*, model.embed_tokens, model.norm, lm_head) for the LM, the
    reference names of `reference_state` for the rest."""
    st = {k: v for k, v in reference_state(params, cfg).items()
          if not k.startswith(LM)}
    lp = params["llada"]
    st["model.embed_tokens.weight"] = lp["wte"]
    st["model.norm.weight"] = lp["ln_f"]["weight"]
    st["lm_head.weight"] = lp["ff_out"]["kernel"].T
    for mod, leaves in lp["blocks"].items():
        for i in range(cfg.llada.n_layers):
            pre = f"model.layers.{i}.{DREAM_LINEARS[mod]}"
            for leaf, a in leaves.items():
                name = "weight" if leaf in ("kernel", "weight") else leaf
                st[f"{pre}.{name}"] = a[i].T if leaf == "kernel" else a[i]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in st.items()}


@pytest.fixture(scope="module")
def params():
    return _params(CFG)


@pytest.fixture(scope="module")
def state(params):
    return reference_state(params, CFG)


def _save_shards(state, path, n_shards=2):
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    keys = sorted(state)
    per = -(-len(keys) // n_shards)
    for i in range(n_shards):
        save_file({k: state[k] for k in keys[i * per:(i + 1) * per]},
                  os.path.join(path, f"model-{i + 1:05d}-of-"
                               f"{n_shards:05d}.safetensors"))


def _save_bin(tensors, path):
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                tensors.items()}, path)


def _config_json(cfg):
    lm, vis = cfg.llada, cfg.vision
    return {
        "model_type": "llava_llada", "d_model": lm.d_model,
        "n_heads": lm.n_heads, "n_kv_heads": lm.n_kv_heads,
        "n_layers": lm.n_layers, "mlp_hidden_size": lm.mlp_hidden_size,
        "block_type": lm.block_type, "activation_type": lm.activation,
        "rope_theta": lm.rope_theta, "layer_norm_type": "rms",
        "vocab_size": lm.vocab_size, "embedding_size": lm.embedding_size,
        "max_sequence_length": lm.max_sequence_length,
        "mask_token_id": lm.mask_token_id, "eos_token_id": lm.eos_token_id,
        "pad_token_id": lm.pad_token_id,
        "mm_hidden_size": vis.mm_hidden_size,
        "mm_projector_type": vis.projector_type,
        "image_aspect_ratio": vis.image_aspect_ratio,
        "image_grid_pinpoints": str([list(p) for p in vis.grid_pinpoints]),
        "mm_patch_merge_type": vis.mm_patch_merge_type,
        "vision_tower_config": {
            "hidden_size": vis.siglip.hidden_size,
            "intermediate_size": vis.siglip.intermediate_size,
            "num_hidden_layers": vis.siglip.num_hidden_layers,
            "num_attention_heads": vis.siglip.num_attention_heads,
            "image_size": vis.siglip.image_size,
            "patch_size": vis.siglip.patch_size}}


def _stale(state):
    """The state with a zero projector (a base the delta must override)."""
    return {k: (np.zeros_like(v) if k.startswith("model.mm_projector.")
                else v) for k, v in state.items()}


def _lora(state, d, fmt):
    """A peft adapter dir (r 4, alpha 8, the `.default` infix) on two LM
    linears, with non_lora_trainables.bin carrying the projector."""
    rng = np.random.default_rng(7)
    adapter = {}
    for t in ("model.transformer.blocks.0.q_proj",
              "model.transformer.blocks.1.ff_out"):
        w = state[t + ".weight"]
        adapter[f"base_model.model.{t}.lora_A.default.weight"] = (
            rng.standard_normal((4, w.shape[1])).astype(np.float32) * 0.1)
        adapter[f"base_model.model.{t}.lora_B.default.weight"] = (
            rng.standard_normal((w.shape[0], 4)).astype(np.float32) * 0.1)
    os.makedirs(d)
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(adapter, os.path.join(d, "adapter_model.safetensors"))
    else:
        _save_bin(adapter, os.path.join(d, "adapter_model.bin"))
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": 4, "lora_alpha": 8,
                   "target_modules": ["q_proj", "ff_out"]}, f)
    _save_bin({f"base_model.model.{k}": v for k, v in state.items()
               if k.startswith("model.mm_projector.")},
              os.path.join(d, "non_lora_trainables.bin"))


def write_case(case, state, tmp):
    """Files of one load case -> (path, base, cfg or None to sniff)."""
    full = str(tmp / "full")
    if case == "safetensors":
        _save_shards(state, full)
        return full, None, CFG
    if case == "bin":
        os.makedirs(full)
        keys = sorted(state)
        for i, part in enumerate((keys[::2], keys[1::2])):
            _save_bin({k: state[k] for k in part}, os.path.join(
                full, f"pytorch_model-{i + 1:05d}-of-00002.bin"))
        return full, None, CFG
    if case == "sniffed":
        _save_shards(state, full)
        with open(os.path.join(full, "config.json"), "w") as f:
            json.dump(_config_json(CFG), f)
        return full, None, None
    if case == "siglip_extra_layer":
        extra = dict(state)
        rng = np.random.default_rng(5)
        i = CFG.vision.siglip.n_layers_used
        for k in [k for k in state if ".encoder.layers.0." in k]:
            extra[k.replace(".layers.0.", f".layers.{i}.")] = (
                rng.standard_normal(state[k].shape).astype(np.float32))
        _save_shards(extra, full)
        return full, None, CFG
    if case == "no_newline":
        _save_shards({k: v for k, v in state.items()
                      if k != "model.image_newline"}, full)
        return full, None, CFG
    base = str(tmp / "base")
    _save_shards(_stale(state), base)
    delta = str(tmp / "delta")
    if case == "projector":
        os.makedirs(delta)
        _save_bin({k: v for k, v in state.items()
                   if k.startswith("model.mm_projector.")},
                  os.path.join(delta, "mm_projector.bin"))
    else:
        _lora(state, delta, case.split("_")[1])
    return delta, base, CFG


def _equal_state_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _jax_port(jm, device="cpu"):
    return LaViDa.from_jax(jm.cfg, jax.tree.map(np.asarray, jm.params),
                           device)


def test_helper_inverts_the_jax_converters(params, state):
    got = convert_lavida_state_dict(state, CFG, jnp.float32)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_array_equal(np.asarray(a), flat_want[path])


def test_dream_helper_inverts_the_jax_converter():
    p = _params(DREAM)
    got = convert_lavida_state_dict(dream_reference_state(p, DREAM), DREAM,
                                    jnp.float32, "dream")
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(p))
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_array_equal(np.asarray(a), flat_want[path])


CASES = ["safetensors", "bin", "projector", "lora_safetensors", "lora_bin",
         "sniffed", "siglip_extra_layer", "no_newline"]


@pytest.mark.parametrize("case", CASES)
def test_load_equals_from_jax_of_jax_load(state, tmp_path, case):
    path, base, cfg = write_case(case, state, tmp_path)
    jm = JLaViDa.load(path, cfg, jnp.bfloat16, base=base)
    tm = LaViDa.load(path, cfg, base=base, device="cpu")
    assert tm.cfg == _jax_port(jm).cfg
    _equal_state_dicts(tm.state_dict(), _jax_port(jm).state_dict())
    if case.startswith(("projector", "lora")):
        # the delta moved the weights (the test bites)
        plain = LaViDa.load(base, CFG, device="cpu").state_dict()
        moved = ["projector.layers.0.weight"] + (
            ["llada.blocks.0.q_proj.weight", "llada.blocks.1.ff_out.weight"]
            if case.startswith("lora") else [])
        for k in moved:
            assert not torch.equal(plain[k], tm.state_dict()[k]), k
    if case == "no_newline":
        assert not tm.image_newline.any()


def test_load_in_float32_equals_jax(state, tmp_path):
    path, base, cfg = write_case("lora_bin", state, tmp_path)
    jm = JLaViDa.load(path, cfg, jnp.float32, base=base)
    tm = LaViDa.load(path, cfg, torch.float32, base=base, device="cpu")
    _equal_state_dicts(tm.state_dict(), _jax_port(jm).state_dict())


def test_sniffed_config_equals_jax(state, tmp_path):
    from lavida_mod_tpu.config import config_from_checkpoint as jsniff
    from lavida_mod_tpu_torch.config import (as_port_config,
                                             config_from_checkpoint)

    path, _, _ = write_case("sniffed", state, tmp_path)
    cfg, fam = config_from_checkpoint(path)
    jcfg, jfam = jsniff(path)
    assert (cfg, fam) == (as_port_config(jcfg), jfam)
    assert cfg == as_port_config(CFG)
    # LaViDa-Dream: a checkpoint in the HF Dream names, its geometry
    # sniffed as JAX sniffs it, loaded bit-equal to from_jax of JAX's load
    dpath = str(tmp_path / "dream")
    _save_shards(dream_reference_state(_params(DREAM), DREAM), dpath)
    lm = DREAM.llada
    dream = {"model_type": "dream", "hidden_size": lm.d_model,
             "num_attention_heads": lm.n_heads,
             "num_key_value_heads": lm.n_kv_heads,
             "num_hidden_layers": lm.n_layers,
             "intermediate_size": lm.mlp_hidden_size,
             "rope_theta": lm.rope_theta, "rms_norm_eps": lm.rms_norm_eps,
             "vocab_size": lm.vocab_size,
             "max_position_embeddings": lm.max_sequence_length,
             "tie_word_embeddings": False,
             "mask_token_id": lm.mask_token_id,
             "eos_token_id": lm.eos_token_id, "pad_token_id": lm.pad_token_id}
    with open(os.path.join(dpath, "config.json"), "w") as f:
        json.dump(dream, f)
    cfg, fam = config_from_checkpoint(dpath)
    jcfg, jfam = jsniff(dpath)
    assert (cfg, fam) == (as_port_config(jcfg), "dream")
    assert cfg.llada.include_qkv_bias and cfg.llada.n_kv_heads == 2
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jm = JLaViDa.load(dpath, DREAM, jdtype, lm_family="dream")
        tm = LaViDa.load(dpath, DREAM, dtype, lm_family="dream",
                         device="cpu")
        assert tm.lm_family == jm.lm_family == "dream"
        _equal_state_dicts(tm.state_dict(), LaViDa.from_jax(
            DREAM, jax.tree.map(np.asarray, jm.params), "cpu",
            lm_family="dream").state_dict())
    assert tm.llada.blocks[1].k_proj.bias.abs().max() > 0
    # the family sniffed from config.json when not given
    assert LaViDa.load(dpath, DREAM, device="cpu").lm_family == "dream"


@pytest.mark.parametrize("key,why", [
    ("model.lm_head.weight", "maps to nothing"),
    (LM + "blocks.2.q_proj.weight", "2 layers"),
    (LM + "blocks.0.q_proj.bias", "no biases"),
    ("model.mm_projector.1.weight", "projector"),
    (VT + "encoder.layers.0.mlp.fc3.weight", "SigLIP"),
    ("transformer.wte.weight", "both map to llada.wte.weight")])
def test_a_key_that_maps_nowhere_raises(state, tmp_path, key, why):
    bad = dict(state)
    bad[key] = np.zeros(4, np.float32)
    _save_shards(bad, tmp_path / "bad")
    with pytest.raises(ValueError, match=why):
        LaViDa.load(str(tmp_path / "bad"), CFG, device="cpu")


def test_a_missing_key_raises(state, tmp_path):
    _save_shards({k: v for k, v in state.items()
                  if k != LM + "blocks.1.up_proj.weight"}, tmp_path / "m")
    with pytest.raises(KeyError, match="blocks.1.up_proj"):
        LaViDa.load(str(tmp_path / "m"), CFG, device="cpu")


def test_lm_only_checkpoint(state, tmp_path):
    lm = {k[len("model."):]: v for k, v in state.items()
          if k.startswith(LM)}
    _save_shards(lm, tmp_path / "lm")
    got = llada_loader.load_torch_checkpoint(str(tmp_path / "lm"),
                                             CFG.llada, device="cpu")
    want = LaViDa.load(*write_case("safetensors", state, tmp_path)[::2],
                       device="cpu").llada
    _equal_state_dicts(got.state_dict(), want.state_dict())


DTYPES = {"BF16": None, "F16": np.float16, "F32": np.float32,
          "F64": np.float64, "I8": np.int8, "U8": np.uint8, "I16": np.int16,
          "I32": np.int32, "I64": np.int64, "BOOL": np.bool_}


def _arrays(rng):
    import ml_dtypes

    out = {}
    for i, (name, dt) in enumerate(DTYPES.items()):
        shape = (3, i + 1) if i % 2 else (i + 2,)
        a = rng.standard_normal(shape) * 50
        a = (a.astype(ml_dtypes.bfloat16) if dt is None
             else (a > 0) if dt is np.bool_ else a.astype(dt))
        out[f"t_{name.lower()}"] = a
    out["empty"] = np.zeros((0, 3), np.float32)
    return out


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_safetensors_io_against_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file

    arrs = _arrays(np.random.default_rng(0))
    ours = {k: _torch(a) for k, a in arrs.items()}
    save_file(arrs, tmp_path / "theirs.safetensors",
              metadata={"format": "pt"})
    sio.save_file(ours, str(tmp_path / "ours.safetensors"),
                  metadata={"format": "pt"})
    assert (tmp_path / "ours.safetensors").read_bytes() == \
        (tmp_path / "theirs.safetensors").read_bytes()
    back = load_file(tmp_path / "ours.safetensors")
    for name, src in (("theirs", None), ("ours", None)):
        with sio.SafetensorsFile(str(tmp_path / f"{name}.safetensors")) as f:
            assert f.metadata == {"format": "pt"}
            for k, a in arrs.items():
                t = f.get(k)
                assert t.dtype == _torch(a).dtype, k
                assert torch.equal(t, _torch(a)), k
        assert torch.equal(t, _torch(a))    # valid after close
    for k, a in arrs.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      a.view(np.uint8))


def test_safetensors_reader_copies_an_unaligned_tensor(tmp_path):
    """Three bytes of U8 before an F32 tensor put it off its alignment
    (a layout the package's writer avoids but the format allows)."""
    header = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [5], "data_offsets": [3, 23]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    body = (np.arange(3, dtype=np.uint8).tobytes()
            + np.arange(5, dtype=np.float32).tobytes())
    (tmp_path / "y.safetensors").write_bytes(
        len(blob).to_bytes(8, "little") + blob + body)
    with sio.SafetensorsFile(str(tmp_path / "y.safetensors")) as f:
        assert torch.equal(f.get("b"), torch.arange(5, dtype=torch.float32))
        assert torch.equal(f.get("a"), torch.arange(3, dtype=torch.uint8))


def test_mixed_layout_after_load_equals_jax(tmp_path):
    state = reference_state(_params(WIDE, seed=1), WIDE)
    _save_shards(state, tmp_path / "w")
    jm = JLaViDa.load(str(tmp_path / "w"), WIDE, jnp.bfloat16)
    jm.to_serving_layout("mixed", fuse=True)
    want = LaViDa.from_jax(
        jm.cfg, jax.tree.map(np.asarray, jm.params), "cpu",
        prefill_params=jax.tree.map(np.asarray, jm.prefill_params))
    tm = LaViDa.load(str(tmp_path / "w"), WIDE, device="cpu")
    tm.to_serving_layout("mixed", fuse=True)
    assert tm.mixed and tm.cfg == want.cfg
    _equal_state_dicts(tm.state_dict(), want.state_dict())


def test_bf16_generation_after_load_token_exact(state, tmp_path):
    path, _, _ = write_case("sniffed", state, tmp_path)
    rng = np.random.default_rng(11)
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    ids = np.concatenate([rng.integers(3, 400, 3), [-200],
                          rng.integers(3, 400, 5)])
    gen = dict(max_new_tokens=16, block_length=16, step_per_block=8)
    ref = strict_jax(f"""
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.models.lavida import LaViDa
from lavida_mod_tpu.ops.short_attention import short_attention

# the vision attention as the TPU runs it: the Pallas kernel
jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
jm = LaViDa.load({path!r})
jm.params["llada"] = jl.unstack_blocks(jm.params["llada"])
OUT["tokens"] = jm.generate_fused(
    IN["ids"], [IN["views"]], [(100, 60)], GenerationConfig(**{gen!r}),
    use_flash_prefill=True)
""", tmp_path, {"ids": ids, "views": views})
    from lavida_mod_tpu_torch.config import GenerationConfig

    tm = LaViDa.load(path, device="cpu")
    assert tm.llada.wte.weight.dtype == torch.bfloat16
    got = tm.generate_fused(ids, [views], [(100, 60)],
                            GenerationConfig(**gen))
    assert len(set(ref["tokens"].tolist())) >= 4, "degenerate reference"
    np.testing.assert_array_equal(got, ref["tokens"])


# the rehearsal's geometry on the CPU: the tiny model with LLaDA's vocab
# and token ids (the rehearsal's tokenizer writes them)
REHEARSAL = CFG.replace(llada=tiny_llada_config(
    vocab_size=126464, embedding_size=126464, mask_token_id=126336,
    eos_token_id=126081, pad_token_id=126081))


@pytest.fixture(scope="module")
def rehearsed(tmp_path_factory):
    from lavida_mod_tpu_torch import rehearse_8b_load

    path = tmp_path_factory.mktemp("rehearsal") / "ckpt"
    out = rehearse_8b_load.rehearse(torch, "cpu", path, keep=True,
                                    log=lambda s: None, cfg=REHEARSAL)
    return path, out


def test_rehearsal_at_a_small_geometry(rehearsed):
    """chip_smoke's checkpoint phase at the toy geometry: it writes,
    checks every loaded tensor against its checksum, lays out, prompts
    with 48 tokens and answers; the checkpoint loads as JAX loads it."""
    path, out = rehearsed
    assert out["layers"] == 2 and out["prompt_ids"] == 49
    assert len(out["tokens"]) == 32 and isinstance(out["answer"], str)
    assert out["bytes_on_disk"] > out["tensor_bytes"] > 0
    tm = LaViDa.load(str(path), device="cpu")
    jm = JLaViDa.load(str(path), dtype=jnp.bfloat16)
    _equal_state_dicts(tm.state_dict(), _jax_port(jm).state_dict())


def test_rehearsal_refuses_a_full_disk(tmp_path, monkeypatch):
    import shutil

    from lavida_mod_tpu_torch import rehearse_8b_load

    usage = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(rehearse_8b_load.shutil, "disk_usage",
                        lambda p: usage._replace(free=10 << 30))
    with pytest.raises(RuntimeError, match="GB short"):
        rehearse_8b_load.rehearse(torch, "cpu", tmp_path / "r")


def test_predict_cli_answers_from_a_checkpoint(rehearsed):
    import subprocess
    import sys

    from torch_jax_strict import REPO

    path, _ = rehearsed
    code = ("import sys\n"
            "for m in ('jax', 'safetensors', 'tokenizers', 'transformers',"
            " 'jinja2', 'ml_dtypes', 'regex'):\n"
            "    sys.modules[m] = None\n"
            "from lavida_mod_tpu_torch.predict import main\n"
            f"main(['--model-path', {str(path)!r}, '--device', 'cpu', "
            "'--mixed', '--max-new-tokens', '8', '--step-per-block', '4'])\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[predict] layout: mixed (fused)" in out.stdout
    assert "[predict] answer:" in out.stdout
    # --tp is bf16 serving: with --mixed it exits in the JAX predict's
    # words (sharded serving itself: tests/test_torch_parallel.py); --shirg
    # runs (SHIRG's 2-view selection on the checkpoint's model and
    # tokenizer)
    bad = subprocess.run([sys.executable, "-m",
                          "lavida_mod_tpu_torch.predict", "--tp", "2",
                          "--mixed"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode != 0 and "--tp is bf16 serving" in bad.stderr
    shirg = subprocess.run(
        [sys.executable, "-c", code.replace("'--mixed', ", "'--shirg', ")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert shirg.returncode == 0, shirg.stderr[-3000:]
    assert "[predict] shirg: 980 tokens" in shirg.stdout
    assert "[predict] answer:" in shirg.stdout


def test_weight_tools_as_jax(state, tmp_path):
    from lavida_mod_tpu.tools import weights as jw
    from lavida_mod_tpu_torch.tools import weights as tw

    rng = np.random.default_rng(9)
    base = {k: v for k, v in list(state.items())[:6]}
    target = {k: v + rng.standard_normal(v.shape).astype(np.float32)
              for k, v in base.items()}
    wte = LM + "wte.weight"
    target[wte] = rng.standard_normal(
        (base[wte].shape[0] + 3, base[wte].shape[1])).astype(np.float32)
    target["extra"] = np.ones(3, np.float32)
    tb = {k: torch.from_numpy(v) for k, v in base.items()}
    tt = {k: torch.from_numpy(v) for k, v in target.items()}
    delta = tw.make_delta(tb, tt)
    jdelta = jw.make_delta(base, target)
    for k in jdelta:
        np.testing.assert_array_equal(delta[k].numpy(), jdelta[k])
    back = tw.apply_delta(tb, delta)
    jback = jw.apply_delta(base, jdelta)
    for k in jback:
        np.testing.assert_array_equal(back[k].numpy(), jback[k])
    _save_shards(state, tmp_path / "src", n_shards=3)
    tw.main(["consolidate", "--src", str(tmp_path / "src"),
             "--dst", str(tmp_path / "one")])
    assert os.listdir(tmp_path / "one") == ["model.safetensors"]
    one = tw.load_state(str(tmp_path / "one"))
    assert sorted(one) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(one[k].numpy(), v)


def test_rehearsal_refuses_a_directory_in_use(tmp_path):
    from lavida_mod_tpu_torch import rehearse_8b_load

    (tmp_path / "mine.txt").write_text("keep me")
    with pytest.raises(RuntimeError, match="not empty"):
        rehearse_8b_load.rehearse(torch, "cpu", tmp_path)
    assert (tmp_path / "mine.txt").read_text() == "keep me"
