"""LoRA in the port (ops/quant.attach_lora, train/lora.py) and the SHIRG
Extra-LoRA harness against the JAX package on the CPU, f32.

  - the LoRA term on a float, a weight-only int8, an A8W8 int8 and a
    grouped-int4 linear within 1e-5 of JAX's `linear` /
    `linear_act_int8` (relative to the largest output), factors carried
    by convert.py;
  - `add_lora` / `add_shirg_lora` pick JAX's linears (split_lora_state
    keys and shapes equal, the scales and the per-layer SHIRG gating
    equal, B zero); `merge_lora` within 1e-6; `split_lora_state` equal to
    JAX's, and `load_lora_state` restores a model's forward;
  - the fused decode plan, the fused head and the fused ViT MLP refuse a
    linear that carries factors; malformed factors raise naming the leaf;
  - two `make_shirg_lora_train_step` updates with JAX's masks injected:
    loss within 1e-5, grad_norm within 1e-4 (relative), the factors
    within 2 lr of JAX's and within lr / 100 on 99 % of their elements,
    every frozen leaf unchanged, the inert lora_b exactly zero and the
    inert lora_a decayed by (1 - lr_t wd) per update as JAX's; the
    projector's factors are inert too (JAX's projector reads kernel and
    bias only);
  - the harness (`--tiny`, its adapter save reloaded bit-equal, the eval
    refusal) and `shirg_compare --tiny --synthetic 2` on the CPU.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import multimodal as jmm
from lavida_mod_tpu.ops import quant as jq
from lavida_mod_tpu.train import lora as jlora
from lavida_mod_tpu.train.loss import forward_process
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.ops.quant import (Int4Linear, Int8Linear,
                                            LoRALinear, attach_lora, has_lora)
from lavida_mod_tpu_torch.train import lora as tlora
from lavida_mod_tpu_torch.train.step import init_train_state

torch.set_num_threads(2)

# 8 SigLIP layers, 7 used: SHIRG's gate leaves q / k of block 6 and v of
# blocks 4-6 inert
CFG = LaViDaConfig(llada=tiny_llada_config(),
                   vision=VisionConfig(siglip=tiny_siglip_config(
                       num_hidden_layers=8), mm_hidden_size=32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_params(seed=0):
    return jmm.init_params(CFG, jax.random.PRNGKey(seed), jnp.float32)


def _with_b(params, value=0.05):
    """Nonzero B factors, so the LoRA term acts."""
    def f(path, a):
        return a + value if getattr(path[-1], "key", None) == "lora_b" else a
    return jax.tree_util.tree_map_with_path(f, params)


# ---------------------------------------------------------------------------
# the LoRA term on each linear kind
# ---------------------------------------------------------------------------

def _linear_params(K=256, N=512, r=8):
    rng = np.random.default_rng(0)
    return {"kernel": (0.05 * rng.standard_normal((K, N))).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(N)).astype(np.float32),
            "lora_a": (0.1 * rng.standard_normal((K, r))).astype(np.float32),
            "lora_b": (0.1 * rng.standard_normal((r, N))).astype(np.float32),
            "lora_scale": np.float32(2.0)}


@pytest.mark.parametrize("kind", ["float", "int8", "int8_act", "int4"])
def test_lora_linear_matches_jax(kind):
    p = _linear_params()
    lora = {k: p[k] for k in ("lora_a", "lora_b", "lora_scale")}
    base = {"kernel": p["kernel"], "bias": p["bias"]}
    if kind.startswith("int8"):
        jp = {**_np(jq.quantize_linear(base)), **lora}
    elif kind == "int4":
        jp = {**_np(jq.quantize_linear4(base)), **lora}
    else:
        jp = p
    x = np.random.default_rng(1).standard_normal((3, 5, 256)).astype(
        np.float32)
    fn = jq.linear_act_int8 if kind == "int8_act" else jq.linear
    want = np.asarray(fn(jnp.asarray(x), jax.tree.map(jnp.asarray, jp)))
    state = state_dict_from_jax({"llada": {"ff_out": jp}})
    state = {k[len("llada.ff_out."):]: v for k, v in state.items()
             if not k.endswith("__trim__")}
    cls = {"float": nn.Linear, "int4": Int4Linear}.get(kind, Int8Linear)
    m = cls(256, 512, device="meta", bias=True)
    attach_lora(m, state["lora_a"], state["lora_b"], state["lora_scale"])
    m.load_state_dict(state, assign=True)
    assert has_lora(m) and (kind != "float" or type(m) is LoRALinear)
    with torch.no_grad():
        got = (m(torch.from_numpy(x), act_int8=True) if kind == "int8_act"
               else m(torch.from_numpy(x)))
    assert _rel(got.numpy(), want) < 1e-5, kind
    no_lora = np.asarray(fn(jnp.asarray(x), jax.tree.map(
        jnp.asarray, {k: v for k, v in jp.items() if k not in lora})))
    assert _rel(no_lora, want) > 1e-3      # the term acts


# ---------------------------------------------------------------------------
# which linears, split / load / merge
# ---------------------------------------------------------------------------

def _shapes(state):
    return {k: {n: tuple(np.shape(v)) for n, v in f.items()}
            for k, f in state.items()}


@pytest.mark.parametrize("recipe", ["default", "shirg", "llada_only"])
def test_footprint_matches_jax(recipe):
    jp = _jax_params()
    tm = LaViDa.random_init(CFG, 0, torch.float32, "cpu")
    if recipe == "shirg":
        jp = jlora.add_shirg_lora(jp, jax.random.PRNGKey(1), rank=4,
                                  alpha=8.0)
        tlora.add_shirg_lora(tm, 1, rank=4, alpha=8.0)
    else:
        target = (jlora.add_lora.__defaults__[2] if recipe == "default"
                  else r"llada/blocks/(q_proj|ff_out)")
        jp = jlora.add_lora(jp, jax.random.PRNGKey(1), rank=4, alpha=8.0,
                            target_re=target)
        tlora.add_lora(tm, 1, rank=4, alpha=8.0, target_re=target)
    want, got = jlora.split_lora_state(jp), tlora.split_lora_state(tm)
    assert _shapes(got) == _shapes(want)
    for k in want:
        np.testing.assert_array_equal(got[k]["lora_scale"].numpy(),
                                      np.asarray(want[k]["lora_scale"]))
        assert not got[k]["lora_b"].any()
        a = got[k]["lora_a"].numpy()
        assert abs(a.std() * 4 - 1) < 0.1, k      # N(0, 1) / rank
    if recipe == "shirg":
        q = got["siglip/layers/q_proj"]["lora_scale"].numpy()
        v = got["siglip/layers/v_proj"]["lora_scale"].numpy()
        np.testing.assert_array_equal(q, [2.0] * 6 + [0.0])
        np.testing.assert_array_equal(v, [2.0] * 4 + [0.0] * 3)


def test_no_linear_matched_raises():
    with pytest.raises(ValueError, match="no linear matched"):
        tlora.add_lora(LaViDa.random_init(CFG, 0, torch.float32, "cpu"),
                       target_re="nothing_here")


@pytest.fixture(scope="module")
def adapted():
    """JAX params with the SHIRG factors (B nonzero) and the port model
    carried from them."""
    jp = _with_b(jlora.add_shirg_lora(_jax_params(), jax.random.PRNGKey(1),
                                      rank=4, alpha=8.0))
    return jp, LaViDa.from_jax(CFG, _np(jp), "cpu")


def test_split_lora_state_equals_jax(adapted):
    jp, tm = adapted
    want, got = jlora.split_lora_state(jp), tlora.split_lora_state(tm)
    assert set(got) == set(want)
    for k, f in want.items():
        for n, v in f.items():
            np.testing.assert_array_equal(got[k][n].numpy(), np.asarray(v))


def test_load_lora_state_restores_the_forward(adapted):
    jp, tm = adapted
    plain = LaViDa.from_jax(CFG, _np(_strip_lora(jp)), "cpu")
    views = np.random.default_rng(2).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    with torch.no_grad():
        want = tm.projector(tm.siglip(torch.from_numpy(views)))
        before = plain.projector(plain.siglip(torch.from_numpy(views)))
        tlora.load_lora_state(plain, tlora.split_lora_state(tm))
        got = plain.projector(plain.siglip(torch.from_numpy(views)))
    assert not torch.equal(before, want)
    assert torch.equal(got, want)


def _strip_lora(tree):
    if isinstance(tree, dict):
        return {k: _strip_lora(v) for k, v in tree.items()
                if not (isinstance(k, str) and k.startswith("lora_"))}
    if isinstance(tree, list):
        return [_strip_lora(v) for v in tree]
    return tree


def test_merge_lora_matches_jax(adapted):
    jp, _ = adapted
    tm = LaViDa.from_jax(CFG, _np(jp), "cpu")
    tlora.merge_lora(tm)
    assert not any(has_lora(m) for _, m in tlora.iter_linears(tm))
    assert type(tm.siglip.layers[0].q_proj) is nn.Linear
    want = state_dict_from_jax(_np(jlora.merge_lora(jp)))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.allclose(got[k], v, atol=1e-6, rtol=0), k


def test_merge_into_int8_raises():
    m = Int8Linear(256, 512, device="cpu")
    attach_lora(m, torch.zeros(256, 4), torch.zeros(4, 512), 1.0)
    model = nn.Module()
    model.lin = m
    with pytest.raises(ValueError, match="int8"):
        tlora.merge_lora(model)


# ---------------------------------------------------------------------------
# the fused gates, the converter's refusals
# ---------------------------------------------------------------------------

def test_fused_paths_refuse_lora():
    from lavida_mod_tpu_torch.predict import tiny_mixed_config

    tm = LaViDa.random_init(tiny_mixed_config(), 0, torch.bfloat16, "cpu")
    tm.to_serving_layout("int4", fuse=True)
    lm = tm.llada
    assert lm.blocks[0].fused_plan(32, False) and lm.head_fusable(32)
    out = lm.blocks[0].attn_out
    attach_lora(out, torch.zeros(out.in_features, 4),
                torch.zeros(4, out.out_features), 2.0)
    attach_lora(lm.ff_out, torch.zeros(lm.ff_out.in_features, 4),
                torch.zeros(4, lm.ff_out.out_features), 2.0)
    assert not lm.blocks[0].fused_plan(32, False)
    assert lm.blocks[1].fused_plan(32, False)
    assert not lm.head_fusable(32)
    sig = tm.siglip
    fc1 = sig.layers[0].fc1
    assert sig.fused_mlp_ok() or sig.cfg.hidden_size % 128
    attach_lora(fc1, torch.zeros(fc1.in_features, 4),
                torch.zeros(4, fc1.out_features), 2.0)
    assert not sig.fused_mlp_ok()
    with pytest.raises(ValueError, match="LoRA"):
        sig(torch.zeros(1, 3, 56, 56), fused_mlp=True)


@pytest.mark.parametrize("case", ["no_b", "no_scale", "chain", "width",
                                  "scale_shape", "ints"])
def test_malformed_lora_raises_naming_the_leaf(case):
    p = _np(_jax_params())
    lin = p["projector"]["layers"][1]
    r = 4
    lin["lora_a"] = np.zeros((64, r), np.float32)
    lin["lora_b"] = np.zeros((r, 64), np.float32)
    lin["lora_scale"] = np.float32(2.0)
    if case == "no_b":
        del lin["lora_b"]
    elif case == "no_scale":
        del lin["lora_scale"]
    elif case == "chain":
        lin["lora_b"] = np.zeros((r + 1, 64), np.float32)
    elif case == "width":
        lin["lora_a"] = np.zeros((32, r), np.float32)
    elif case == "scale_shape":
        lin["lora_scale"] = np.ones((2,), np.float32)
    else:
        lin["lora_a"] = np.zeros((64, r), np.int8)
    with pytest.raises(ValueError, match="projector/layers/1/lora_"):
        state_dict_from_jax(p)


def test_stacked_factors_convert_per_layer(adapted):
    jp, _ = adapted
    state = state_dict_from_jax(_np(jp))
    a = np.asarray(jp["siglip"]["layers"]["k_proj"]["lora_a"])
    for i in range(a.shape[0]):
        np.testing.assert_array_equal(
            state[f"siglip.layers.{i}.k_proj.lora_a"].numpy(), a[i])
        assert state[f"siglip.layers.{i}.k_proj.lora_scale"].dim() == 0


# ---------------------------------------------------------------------------
# the SHIRG-LoRA step
# ---------------------------------------------------------------------------

LR, WD = 1e-2, 0.01


def _batch(n_img, B=2, T=12):
    S = CFG.vision.siglip.image_size
    rng = np.random.default_rng(0)
    pix = rng.standard_normal((B, 2, 3, S, S)).astype(np.float32)
    text = rng.integers(3, 400, size=(B, T)).astype(np.int32)
    labels = np.concatenate([np.full((B, n_img), -100), text], axis=1)
    labels[:, n_img:n_img + 3] = -100
    return pix, text, labels.astype(np.int64)


@pytest.fixture(scope="module")
def step_ref():
    jp = jlora.add_shirg_lora(_jax_params(), jax.random.PRNGKey(1), rank=4,
                              alpha=8.0)
    opt = jlora.make_lora_optimizer(lr=LR, weight_decay=WD, warmup_steps=0,
                                    total_steps=10)
    step = jlora.make_shirg_lora_train_step(CFG, opt)
    pix, text, labels = _batch(20)
    batch = {"pixel_values": jnp.asarray(pix), "text_ids": jnp.asarray(text),
             "labels": jnp.asarray(labels)}
    p, st, out = jp, opt.init(jp), []
    for i in range(2):
        key = jax.random.PRNGKey(42 + i)
        mask = np.asarray(forward_process(jax.random.split(key)[1],
                                          *labels.shape)[0])
        p, st, m = step(p, st, batch, key)
        out.append((mask, float(m["loss"]), float(m["grad_norm"]),
                    _np(jlora.split_lora_state(p))))
    return _np(jp), out


def test_shirg_lora_step_matches_jax(step_ref):
    jp0, ref = step_ref
    tm = LaViDa.from_jax(CFG, jp0, "cpu")
    opt = tlora.make_lora_optimizer(lr=LR, weight_decay=WD, warmup_steps=0,
                                    total_steps=10)
    state = init_train_state(tm, opt)
    assert set(state.masters) == {n for n, _ in tm.named_parameters()
                                  if n.endswith((".lora_a", ".lora_b"))}
    frozen0 = {n: p.detach().clone() for n, p in tm.named_parameters()
               if n not in state.masters}
    a0 = tlora.split_lora_state(tm)
    step = tlora.make_shirg_lora_train_step(CFG, opt)
    pix, text, labels = _batch(20)
    batch = {"pixel_values": torch.from_numpy(pix),
             "text_ids": torch.from_numpy(text),
             "labels": torch.from_numpy(labels)}
    for i, (mask, loss, gnorm, want) in enumerate(ref):
        m = step(state, batch, masked_indices=torch.from_numpy(mask))
        assert m["loss"].item() == pytest.approx(loss, rel=1e-5), i
        assert m["grad_norm"].item() == pytest.approx(gnorm, rel=1e-4), i
        got = tlora.split_lora_state(tm)
        far = total = 0
        for k, f in want.items():
            for n in ("lora_a", "lora_b"):
                d = np.abs(got[k][n].numpy() - f[n])
                assert d.max() <= 2 * LR * (i + 1) * 1.001, (k, n)
                far += int((d > LR / 100).sum())
                total += d.size
        assert far <= 0.01 * total, (far, total)
    for n, p in tm.named_parameters():
        if n in frozen0:
            assert torch.equal(p, frozen0[n]), n
    # the inert factors: B stays zero, A decays by (1 - lr wd) per update
    # (optax.adamw's unmasked decoupled decay), as in JAX
    got = tlora.split_lora_state(tm)
    assert not got["projector/layers/0"]["lora_b"].any()
    for k, rows in (("siglip/layers/q_proj", [6]),
                    ("siglip/layers/v_proj", [4, 5, 6])):
        for i in rows:
            assert not got[k]["lora_b"][i].any()
            decayed = a0[k]["lora_a"][i]
            for c in range(len(ref)):      # lr_t of the warmup-free cosine
                lr_t = float(np.float32(opt.groups["lora"].lr(c)))
                decayed = decayed + (-lr_t) * (WD * decayed)
            assert torch.allclose(got[k]["lora_a"][i], decayed, rtol=1e-6,
                                  atol=0)
            np.testing.assert_allclose(got[k]["lora_a"][i].numpy(),
                                       ref[-1][3][k]["lora_a"][i],
                                       rtol=1e-6, atol=0)
            assert not np.asarray(ref[-1][3][k]["lora_b"][i]).any()


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from lavida_mod_tpu_torch.tools.make_synthetic_data import main as make

    d = tmp_path_factory.mktemp("syn")
    make([str(d), "--n", "6", "--size", "96"])
    return d


def test_harness_tiny_saves_and_reloads(synthetic, tmp_path, monkeypatch):
    from lavida_mod_tpu_torch import train_shirg_lora as h

    argv = ["--tiny", "--device", "cpu", "--data-path",
            str(synthetic / "data.json"), "--image-folder",
            str(synthetic / "images"), "--output-dir", str(tmp_path / "run"),
            "--steps", "3", "--warmup-steps", "1", "--lr", "1e-2",
            "--save-every", "2"]
    run = h.main(argv)
    assert len(run["losses"]) == 3 and np.isfinite(run["losses"]).all()
    assert [os.path.basename(p) for p in run["saved"]] == [
        "checkpoint-2", "checkpoint-3"]
    model = run["state"].model
    saved = h.load_adapters(run["saved"][-1])
    live = tlora.split_lora_state(model)
    assert set(saved) == set(live)
    fresh = LaViDa.random_init(h_tiny_cfg(), 0, torch.float32, "cpu")
    tlora.load_lora_state(fresh, saved)
    again = tlora.split_lora_state(fresh)
    for k, f in live.items():
        for n, v in f.items():
            assert torch.equal(again[k][n], v), (k, n)
    # SigLIP's B left zero; the projector's do not act (as in JAX)
    assert all(live[k]["lora_b"].any() == k.startswith("siglip")
               for k in live)
    # the in-training eval runs as the script's: no data paths, so the
    # documents need `datasets` (tests/test_torch_eval_hook.py)
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ModuleNotFoundError):
        h.main(argv + ["--eval-every", "2", "--eval-tasks", "mmmu_val"])


def h_tiny_cfg():
    return LaViDaConfig(llada=tiny_llada_config(),
                        vision=VisionConfig(siglip=tiny_siglip_config(),
                                            mm_hidden_size=32))


def test_shirg_compare_tiny(tmp_path):
    from lavida_mod_tpu_torch.shirg_compare import exact_match, main

    out = tmp_path / "cmp.json"
    summary = main(["--tiny", "--synthetic", "2", "--device", "cpu",
                    "--max-new-tokens", "8", "--output", str(out)])
    assert summary["n"] == 2 and summary["device"] == "cpu"
    assert all(r["shirg_tokens"] == 980 for r in summary["results"])
    assert json.loads(out.read_text())["n"] == 2
    assert exact_match("The cat.", "the  CAT") == 1.0
    assert exact_match("a dog", "cat") == 0.0
