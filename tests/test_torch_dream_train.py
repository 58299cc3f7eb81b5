"""Training at Dream geometry (GQA, Qwen2's QKV bias) against the JAX
package on the CPU.

  - one `make_multimodal_train_step` microstep of a tiny LaViDa whose LM
    has n_kv_heads < n_heads and the q/k/v biases, in the mixed-precision
    policy, stage 1 and stage 2, with JAX's mask injected: the loss, every
    trainable gradient (the biases' included) and the updated f32 masters
    within the bands of tests/test_torch_train.py's LLaDA step.  The loss
    is JAX's for both families: the unshifted masked cross-entropy
    (lavida_mod_tpu/train/loss.py); whether the reference shifts for Dream
    is unverified there, and the port does not;
  - the training CLI with `--style dream --model-path` of a tiny Dream
    checkpoint on disk (HF Dream names and a config.json): train.py passes
    its own geometry, which has no QKV bias, and JAX's load keeps the
    checkpoint's biases anyway and trains with them; the port's CLI does
    the same.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.config import (LaViDaConfig, VisionConfig,
                                         tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu_torch.convert import masters_from_jax, state_dict_from_jax
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.models.multimodal import multimodal_embeds
from lavida_mod_tpu_torch.train import cli
from lavida_mod_tpu_torch.train import step as tstep
from lavida_mod_tpu_torch.train.loss import diffusion_loss
from lavida_mod_tpu_torch.tools.make_synthetic_data import make
from test_torch_train import (_FLATTEN, STEP_LR, TUNABLE, _rel, _step_batch,
                              _tree, params_np)
from torch_jax_strict import strict_jax

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def _dream_cfg():
    # d_model 128: the TPU gather kernel (interpret mode) takes whole
    # 128-lane rows; 4 query heads over 2 KV heads
    return LaViDaConfig(
        llada=tiny_llada_config(d_model=128, include_qkv_bias=True),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                            grid_pinpoints=((56, 112), (112, 56),
                                            (112, 112))))


def test_the_geometry_is_dreams():
    lm = _dream_cfg().llada
    assert lm.n_kv_heads < lm.n_heads and lm.include_qkv_bias
    model = LaViDa(_dream_cfg(), "meta", lm_family="dream")
    blk = model.llada.blocks[0]
    assert blk.k_proj.out_features == lm.n_kv_heads * lm.head_dim
    assert all(getattr(blk, n).bias is not None
               for n in ("q_proj", "k_proj", "v_proj"))
    assert blk.attn_out.bias is None


@pytest.fixture(scope="module")
def dream_ref(tmp_path_factory):
    cfg = _dream_cfg()
    return strict_jax("import jax, jax.numpy as jnp\n" + _FLATTEN + f"""
from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import multimodal as mm
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.ops import pallas_gather as pg
from lavida_mod_tpu.ops.short_attention import short_attention
from lavida_mod_tpu.train.loss import diffusion_loss, forward_process
from lavida_mod_tpu.train.step import (cast_floating, make_freeze_optimizer,
                                       make_multimodal_train_step)
jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
pg.gather_rows_auto = lambda t, i: pg.gather_rows_ad(t, i, interpret=True)
cfg = LaViDaConfig(
    llada=tiny_llada_config(d_model=128, include_qkv_bias=True),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
params = mm.init_params(cfg, jax.random.PRNGKey(3))
# Dream checkpoints carry nonzero biases; the init's are zeros
blocks = params["llada"]["blocks"]
for i, n in enumerate(("q_proj", "k_proj", "v_proj")):
    b = blocks[n]["bias"]
    blocks[n]["bias"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(11 + i), b.shape, b.dtype)
flat("params/", params)
batch = {{k: jnp.asarray(IN[k]) for k in
         ("pixel_values", "text_ids", "gather_idx", "labels")}}
key = jax.random.PRNGKey(9)
B, T = batch["labels"].shape
OUT["mask"] = np.asarray(forward_process(key, B, T)[0])

def loss_fn(p):
    p = cast_floating(p, jnp.bfloat16)
    emb = mm.multimodal_embeds(p, cfg, batch["pixel_values"],
                               batch["text_ids"], batch["gather_idx"],
                               remat=True)
    return diffusion_loss(p["llada"], cfg.llada, emb, batch["labels"], key,
                          remat=True)

(loss, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
OUT["loss"] = np.asarray(loss)
flat("grad/", grads)

def loss_f32(p):
    emb = mm.multimodal_embeds(p, cfg, batch["pixel_values"],
                               batch["text_ids"], batch["gather_idx"])
    return diffusion_loss(p["llada"], cfg.llada, emb, batch["labels"], key,
                          remat=False)

(loss, m), grads = jax.jit(jax.value_and_grad(loss_f32, has_aux=True))(params)
OUT["loss32"] = np.asarray(loss)
flat("grad32/", grads)
for name, parts in {TUNABLE!r}.items():
    opt = make_freeze_optimizer(parts, lr={STEP_LR}, warmup_steps=0,
                                total_steps=10)
    step = jax.jit(make_multimodal_train_step(
        cfg, opt, remat=True, compute_dtype=jnp.bfloat16))
    new, _, metrics = step(params, opt.init(params), batch, key)
    flat(name + "/new/", new)
    OUT[name + "/loss"] = np.asarray(metrics["loss"])
    OUT[name + "/grad_norm"] = np.asarray(metrics["grad_norm"])
""", tmp_path_factory.mktemp("dream_step"), _step_batch(cfg))


@pytest.mark.parametrize("stage", list(TUNABLE))
def test_dream_multimodal_step_matches_jax(dream_ref, stage):
    """bf16 compute on f32 masters, one microstep with JAX's mask.  Bands:
    loss within 1 %; each trainable gradient within 10 % in L2 of JAX's
    and within 20 % of its largest magnitude elementwise (the LLaDA step
    holds 10 % there; here the LM's q/k/v biases and norm weights, sums
    over every row of small bf16 terms, reach 13-17 %, while the same
    gradients in f32 agree within 1e-3: test_dream_f32_gradients_match_jax);
    the k bias is added before RoPE, so unlike the tower's it is no shift
    shared by all keys and has a gradient; grad_norm within 2 %; every
    updated master within 2 lr of JAX's and within lr / 100 on 98 % of the
    trainable elements; frozen leaves bit-identical."""
    cfg = _dream_cfg()
    ref = dream_ref
    params = _tree(ref, "params/")
    batch = _step_batch(cfg)
    mask = torch.from_numpy(ref["mask"])
    opt = tstep.make_freeze_optimizer(TUNABLE[stage], lr=STEP_LR,
                                      warmup_steps=0, total_steps=10)
    model = LaViDa.from_jax(cfg, params, "cpu", lm_family="dream")
    state = tstep.init_train_state(model, opt, torch.bfloat16,
                                   masters_from_jax(params, "cpu"))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n not in state.masters}

    emb = multimodal_embeds(model, torch.from_numpy(batch["pixel_values"]),
                            batch["text_ids"], batch["gather_idx"], remat=True)
    loss, _ = diffusion_loss(model.llada, emb,
                             torch.from_numpy(batch["labels"]),
                             masked_indices=mask)
    assert abs(loss.item() - float(ref["loss"])) < 0.01 * float(ref["loss"])
    loss.backward()
    params_t = dict(model.named_parameters())
    want = {n: t.numpy() for n, t in
            state_dict_from_jax(_tree(ref, "grad/")).items()}
    biases = 0
    for n in state.masters:
        g = params_t[n].grad.float().numpy()
        if n.startswith("siglip.") and n.endswith("k_proj.bias"):
            # the tower has no RoPE: zero in exact arithmetic
            scale = np.abs(want[n.replace("k_proj", "q_proj")]).max()
            assert max(np.abs(g).max(), np.abs(want[n]).max()) < 1e-3 * scale
        else:
            assert _rel(g, want[n]) < 0.2, n
            assert (np.linalg.norm(g - want[n])
                    < 0.1 * np.linalg.norm(want[n])), n
        biases += n.startswith("llada.") and n.endswith("_proj.bias")
    for p in model.parameters():
        p.grad = None
    assert biases == (0 if stage == "stage1" else 3 * cfg.llada.n_layers)

    step = tstep.make_multimodal_train_step(cfg, opt, remat=True)
    metrics = step(state, batch, masked_indices=mask)
    assert abs(metrics["loss"].item() - float(ref[f"{stage}/loss"])) \
        < 0.01 * float(ref[f"{stage}/loss"])
    jnorm = float(ref[f"{stage}/grad_norm"])
    assert abs(metrics["grad_norm"].item() - jnorm) < 0.02 * jnorm
    new = state_dict_from_jax(_tree(ref, f"{stage}/new/"))
    far = total = 0
    for n, m in state.masters.items():
        d = np.abs(m.numpy() - new[n].numpy())
        assert d.max() <= 2 * STEP_LR * 1.001, n
        far, total = far + int((d > STEP_LR / 100).sum()), total + d.size
        assert not torch.equal(m, torch.from_numpy(params_np(params, n))), n
    assert far <= 0.02 * total, (far, total)
    for n, t in frozen.items():
        assert torch.equal(params_t[n].detach(), t), n


def test_dream_f32_gradients_match_jax(dream_ref):
    """The same loss in f32 with JAX's mask: the loss within 1e-5 and every
    parameter's gradient (the q/k/v biases, the GQA projections, the tower)
    within 1e-3 of its largest magnitude."""
    cfg = _dream_cfg()
    params = _tree(dream_ref, "params/")
    batch = _step_batch(cfg)
    model = LaViDa.from_jax(cfg, params, "cpu", lm_family="dream")
    for p in model.parameters():
        p.requires_grad_(True)
    emb = multimodal_embeds(model, torch.from_numpy(batch["pixel_values"]),
                            batch["text_ids"], batch["gather_idx"])
    loss, _ = diffusion_loss(model.llada, emb,
                             torch.from_numpy(batch["labels"]),
                             masked_indices=torch.from_numpy(
                                 dream_ref["mask"]), remat=False)
    assert loss.item() == pytest.approx(float(dream_ref["loss32"]), rel=1e-5)
    loss.backward()
    want = state_dict_from_jax(_tree(dream_ref, "grad32/"))
    for n, p in model.named_parameters():
        if n.startswith("siglip.") and n.endswith("k_proj.bias"):
            continue        # rounding noise on both sides (no RoPE there)
        assert _rel(p.grad.numpy(), want[n].numpy()) < 1e-3, n


# ---------------------------------------------------------------------------
# the CLI on a Dream checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dream_run(tmp_path_factory):
    """A tiny Dream checkpoint (the tiny LLaDA geometry with GQA and nonzero
    QKV biases, in HF Dream names) and synthetic data."""
    from test_torch_checkpoint import (DREAM, _params, _save_shards,
                                       dream_reference_state)

    d = tmp_path_factory.mktemp("dream_cli")
    params = _params(DREAM)
    rng = np.random.default_rng(2)
    for n in ("q_proj", "k_proj", "v_proj"):
        b = params["llada"]["blocks"][n]["bias"]
        params["llada"]["blocks"][n]["bias"] = (
            0.05 * rng.standard_normal(b.shape)).astype(np.float32)
    ckpt = d / "dream"
    _save_shards(dream_reference_state(params, DREAM), str(ckpt))
    lm = DREAM.llada
    with open(ckpt / "config.json", "w") as f:
        json.dump({"model_type": "dream", "hidden_size": lm.d_model,
                   "num_attention_heads": lm.n_heads,
                   "num_key_value_heads": lm.n_kv_heads,
                   "num_hidden_layers": lm.n_layers,
                   "intermediate_size": lm.mlp_hidden_size,
                   "rope_theta": lm.rope_theta,
                   "rms_norm_eps": lm.rms_norm_eps,
                   "vocab_size": lm.vocab_size,
                   "max_position_embeddings": lm.max_sequence_length,
                   "tie_word_embeddings": False,
                   "mask_token_id": lm.mask_token_id,
                   "eos_token_id": lm.eos_token_id,
                   "pad_token_id": lm.pad_token_id}, f)
    data = make(str(d / "syn"), n=8, size=96)
    return str(ckpt), data, str(d / "syn" / "images"), params


def _dream_argv(run, out, *extra):
    ckpt, data, images, _ = run
    return ["--tiny", "--style", "dream", "--model-path", ckpt,
            "--data-path", data, "--image-folder", images,
            "--output-dir", str(out), "--batch-size", "2", "--steps", "2",
            "--log-every", "1", "--prefetch", "0", *extra]


def test_cli_trains_a_dream_checkpoint_as_train_py_does(dream_run, tmp_path):
    """JAX's train.py --tiny --style dream --model-path trains two steps
    (its config has no QKV bias; its load keeps the checkpoint's); the
    port's CLI loads the same checkpoint with the biases and trains:
    finite losses, the biases in the model and moved by the updates,
    the tiny geometry's GQA kept."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(REPO / "train.py"),
         *_dream_argv(dream_run, tmp_path / "jax")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[train] step 2:" in proc.stdout

    run = cli.main(_dream_argv(dream_run, tmp_path / "port", "--device",
                               "cpu"))
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    model = run["state"].model
    assert model.lm_family == "dream"
    lm = model.llada.cfg
    assert lm.include_qkv_bias and lm.n_kv_heads == 2 < lm.n_heads
    start = dream_run[3]["llada"]["blocks"]["q_proj"]["bias"]
    masters = run["state"].masters
    for i in range(lm.n_layers):
        b = masters[f"llada.blocks.{i}.q_proj.bias"]
        assert not np.allclose(b.numpy(), start[i], atol=0), i
        assert np.abs(b.numpy() - start[i]).max() < 0.01


def test_silu_gradient_is_finite_where_exp_overflows():
    """Found by the Dream checkpoint run: autograd through x / (1 +
    exp(-x)) gave NaN once exp(-x) overflowed (a gate pre-activation under
    -88.7), so every gradient of the step was NaN.  The port's silu keeps
    its forward and autograd's backward bit for bit elsewhere and gives
    jax.nn.silu's gradient there."""
    import jax
    import jax.numpy as jnp

    from lavida_mod_tpu_torch.ops.activations import silu

    x = torch.tensor([-120.0, -95.0, -89.0, -3.0, 0.5, 40.0])
    g = torch.tensor([1.0, -2.0, 0.5, 1.5, -1.0, 2.0])
    t = x.clone().requires_grad_(True)
    y = silu(t)
    y.backward(g)
    assert torch.isfinite(t.grad).all()
    want = jax.vmap(jax.grad(jax.nn.silu))(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want) * g.numpy(),
                               rtol=1e-6, atol=1e-30)
    ref = x.clone().requires_grad_(True)
    (ref * (1.0 / (1.0 + torch.exp(-ref)))).backward(g)
    assert torch.equal(y.detach(), ref * (1.0 / (1.0 + torch.exp(-ref))))
    finite = torch.isfinite(ref.grad)
    assert not finite.all()
    assert torch.equal(t.grad[finite], ref.grad[finite])
