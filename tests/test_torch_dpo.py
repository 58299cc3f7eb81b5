"""The port's DPO (lavida_mod_tpu_torch.train.dpo) against the JAX package's
train/dpo.py on the CPU, in f32:

  - `dpo_loss` with policy == reference is log 2 with a zero margin
    (tests/test_dpo_tools.py:39-50);
  - `dpo_loss` with JAX's two mask patterns injected (JAX draws them from
    jax.random, the port from a torch.Generator): loss, every metric and
    every gradient of the policy agree with JAX's;
  - `make_dpo_train_step`: one step on the port's optimizer against the
    JAX step on JAX's optimizer, the same masks: metrics and updated
    weights; and over 6 steps of Adam at 5e-3 the margin rises
    (tests/test_dpo_tools.py:53-68);
  - the LoRA form: the reference is the policy with its factors off, one
    base for both; at init (LoRA B = 0) the loss is log 2;
  - the trl-exact AR half: `ar_batch_logps`, all four `ar_dpo_loss`
    types and `ar_dpo_batch_loss` (with a tiny forward written the same on
    both sides) equal JAX's, gradients included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import tiny_llada_config as jtiny
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.train import dpo as jdpo
from lavida_mod_tpu.train.loss import forward_process as jforward_process
from lavida_mod_tpu.train.step import make_optimizer as jmake_optimizer
from lavida_mod_tpu_torch.config import tiny_llada_config
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.models.llada import LLaDA
from lavida_mod_tpu_torch.train import dpo
from lavida_mod_tpu_torch.train import step as tstep
from lavida_mod_tpu_torch.train.lora import add_lora, make_lora_optimizer

torch.set_num_threads(2)
BETA = 0.1


def _port_lm(params):
    lm = LLaDA(tiny_llada_config(), "cpu", torch.float32)
    lm.load_state_dict({k[len("llada."):]: v for k, v in
                        state_dict_from_jax({"llada": jax.tree.map(
                            np.asarray, params)}).items()}, strict=True)
    return lm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def tiny():
    cfg = jtiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    # a reference that differs from the policy, so the margin is not 0
    ref = jax.tree.map(lambda a: a + 0.01 * jax.random.normal(
        jax.random.PRNGKey(5), a.shape, a.dtype), params)
    rng = np.random.default_rng(0)
    B, L = 2, 16
    ids_c = rng.integers(3, 400, size=(B, L))
    ids_r = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[0, 8:], labels[1, 6:] = 1, 1
    lab_c = np.where(labels != -100, ids_c, -100)
    lab_r = np.where(labels != -100, ids_r, -100)
    # the batch's embeds are the policy's at init, as both packages'
    # tests build them
    emb_c = np.asarray(jl.embed_tokens(params, jnp.asarray(ids_c)))
    emb_r = np.asarray(jl.embed_tokens(params, jnp.asarray(ids_r)))
    return cfg, params, ref, {"chosen_embeds": emb_c, "chosen_labels": lab_c,
                              "rejected_embeds": emb_r,
                              "rejected_labels": lab_r}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _jmasks(key, B, L):
    kc, kr = jax.random.split(key)
    return tuple((torch.from_numpy(np.asarray(m)),
                  torch.from_numpy(np.asarray(p)))
                 for m, p in (jforward_process(kc, B, L),
                              jforward_process(kr, B, L)))


def test_dpo_loss_at_init_is_log2(tiny):
    """policy == reference -> logits 0 -> loss = -log sigmoid(0) = log 2;
    the port's masks from its own generator."""
    _, params, _, b = tiny
    lm = _port_lm(params)
    t = _tbatch(b)
    loss, m = dpo.dpo_loss(lm, lm, t["chosen_embeds"], t["chosen_labels"],
                           t["rejected_embeds"], t["rejected_labels"],
                           torch.Generator().manual_seed(0), remat=False)
    assert loss.item() == pytest.approx(np.log(2.0), abs=1e-6)
    assert abs(m["reward_margin"].item()) < 1e-6
    assert set(m) == {"dpo_loss", "reward_margin", "reward_acc",
                      "logp_chosen", "logp_rejected"}


@pytest.mark.parametrize("prefix_lm", [True, False])
def test_dpo_loss_matches_jax(tiny, prefix_lm):
    """JAX's masks injected: loss and metrics within 1e-5 relative (the
    log-prob proxies within 1e-5 of their magnitude), every policy
    gradient within 1e-4 of its largest magnitude."""
    cfg, params, ref, b = tiny
    key = jax.random.PRNGKey(3)

    def jloss(p):
        return jdpo.dpo_loss(p, ref, cfg, *(_jbatch(b)[k] for k in (
            "chosen_embeds", "chosen_labels", "rejected_embeds",
            "rejected_labels")), key, beta=BETA, prefix_lm=prefix_lm,
            remat=False)

    (jl_, jm), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    lm, ref_lm = _port_lm(params), _port_lm(ref)
    t = _tbatch(b)
    loss, m = dpo.dpo_loss(lm, ref_lm, t["chosen_embeds"], t["chosen_labels"],
                           t["rejected_embeds"], t["rejected_labels"],
                           beta=BETA, prefix_lm=prefix_lm, remat=False,
                           masks=_jmasks(key, 2, 16))
    loss.backward()
    assert loss.item() == pytest.approx(float(jl_), rel=1e-5)
    for k in m:
        scale = max(abs(float(jm[k])), 1.0)
        assert abs(m[k].item() - float(jm[k])) < 1e-5 * scale, k
    assert abs(m["reward_margin"].item()) > 1e-3
    want = state_dict_from_jax({"llada": jax.tree.map(np.asarray, jg)})
    for n, p in lm.named_parameters():
        assert _rel(p.grad.numpy(), want[f"llada.{n}"].numpy()) < 1e-4, n
    assert all(p.grad is None for p in ref_lm.parameters())


def test_dpo_step_matches_jax_and_the_margin_rises(tiny):
    """make_dpo_train_step on make_optimizer (lr 5e-3, the same on both
    sides) with JAX's masks: the first step's metrics within 1e-5 and the
    updated weights within 2 lr of JAX's (one Adam step moves a leaf by ~lr
    * sign(g)) and within lr / 100 on 99 % of them; grad_norm is the
    global norm of JAX's gradient.  Then 6 steps of Adam at 5e-3 on the
    same pair and masks (test_dpo_tools.py:53-68): the margin rises and
    stays finite.  reward_acc is left out of the first step's comparison:
    with policy == reference each row's logit is rounding noise about 0."""
    cfg, params, _, b = tiny
    lr, key = 5e-3, jax.random.PRNGKey(42)
    jopt = jmake_optimizer(lr=lr, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jdpo.make_dpo_train_step(cfg, jopt, params, beta=BETA,
                                             remat=False))
    new, _, jm = jstep(params, jopt.init(params), _jbatch(b), key)

    def jloss(p):
        return jdpo.dpo_loss(p, params, cfg, *(_jbatch(b)[k] for k in (
            "chosen_embeds", "chosen_labels", "rejected_embeds",
            "rejected_labels")), key, beta=BETA, remat=False)[0]

    jgnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(
        jax.grad(jloss)(params)))))

    lm, ref_lm = _port_lm(params), _port_lm(params)
    opt = tstep.make_optimizer(lr=lr, warmup_steps=0, total_steps=10)
    state = tstep.init_train_state(lm, opt)
    step = dpo.make_dpo_train_step(None, opt, ref_lm, beta=BETA, remat=False)
    masks = _jmasks(key, 2, 16)
    m = step(state, _tbatch(b), masks=masks)
    for k in jm:
        if k == "reward_acc":
            continue    # policy == reference: each row's logit is rounding
        scale = max(abs(float(jm[k])), 1.0)
        assert abs(m[k].item() - float(jm[k])) < 1e-5 * scale, k
    assert m["grad_norm"].item() == pytest.approx(jgnorm, rel=1e-4)
    want = state_dict_from_jax({"llada": jax.tree.map(np.asarray, new)})
    far = total = 0
    for n, p in lm.named_parameters():
        d = (p.detach() - want[f"llada.{n}"]).abs()
        assert d.max().item() <= 2 * lr * 1.001, n
        far, total = far + int((d > lr / 100).sum()), total + d.numel()
    assert far <= 0.01 * total, (far, total)

    adam = tstep.Optimizer(tstep.label_params, {"base": tstep.AdamW(
        lambda c: lr, grad_clip=float("inf"))})
    lm = _port_lm(params)
    state = tstep.init_train_state(lm, adam)
    step = dpo.make_dpo_train_step(None, adam, ref_lm, beta=BETA,
                                   remat=False)
    margins = [step(state, _tbatch(b), masks=masks)["reward_margin"].item()
               for _ in range(6)]
    assert margins[-1] > margins[0] and np.isfinite(margins).all(), margins


def test_lora_dpo_shares_the_base(tiny):
    """add_lora on the LM's linears with make_lora_optimizer and
    reference=None: the first step's loss is log 2 (LoRA B = 0), the base
    weights stay bit-unchanged while the B factors move, the margin
    becomes nonzero, and the reference passes leave the factors in place."""
    _, params, _, b = tiny
    lm = _port_lm(params)
    base = {n: p.detach().clone() for n, p in lm.named_parameters()}
    add_lora(lm, seed=1, rank=4)
    opt = make_lora_optimizer(lr=1e-2, total_steps=10, warmup_steps=0)
    state = tstep.init_train_state(lm, opt)
    step = dpo.make_dpo_train_step(None, opt, None, beta=BETA, remat=True)
    gen = torch.Generator().manual_seed(0)
    m1 = step(state, _tbatch(b), gen)
    assert m1["dpo_loss"].item() == pytest.approx(np.log(2.0), abs=1e-6)
    m2 = step(state, _tbatch(b), gen)
    assert abs(m2["reward_margin"].item()) > 0
    assert np.isfinite([m2["dpo_loss"].item(), m2["grad_norm"].item()]).all()
    params_now = dict(lm.named_parameters())
    for n, t in base.items():
        assert torch.equal(params_now[n].detach(), t), n
    lora_b = [n for n in params_now if n.endswith("lora_b")]
    assert lora_b and all(params_now[n].abs().max() > 0 for n in lora_b)
    assert all(params_now[n.replace("lora_b", "lora_a")] is not None
               for n in lora_b)


# ---------------------------------------------------------------------------
# trl-exact AR DPO
# ---------------------------------------------------------------------------

def _ar_batch(seed=0, B=3, L=9, V=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, L, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, L))
    labels[:, :3] = -100
    labels[1, 7:] = -100
    return logits, labels


@pytest.mark.parametrize("avg", [False, True])
def test_ar_batch_logps_matches_jax(avg):
    logits, labels = _ar_batch()
    want = jdpo.ar_batch_logps(jnp.asarray(logits), jnp.asarray(labels),
                               average_log_prob=avg)
    got = dpo.ar_batch_logps(torch.from_numpy(logits),
                             torch.from_numpy(labels), average_log_prob=avg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("loss_type", ["sigmoid", "hinge", "ipo",
                                       "kto_pair"])
@pytest.mark.parametrize("reference_free", [False, True])
def test_ar_dpo_loss_types_match_jax(loss_type, reference_free):
    rng = np.random.default_rng(1)
    lps = [rng.standard_normal(4).astype(np.float32) for _ in range(4)]
    kw = dict(beta=0.25, label_smoothing=0.1 if loss_type == "sigmoid"
              else 0.0, loss_type=loss_type, reference_free=reference_free)
    want = jdpo.ar_dpo_loss(*map(jnp.asarray, lps), **kw)
    got = dpo.ar_dpo_loss(*map(torch.from_numpy, lps), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss type"):
        dpo.ar_dpo_loss(*map(torch.from_numpy, lps), loss_type="nope")


@pytest.mark.parametrize("loss_type", ["sigmoid", "hinge", "ipo",
                                       "kto_pair"])
def test_ar_dpo_batch_loss_matches_jax(loss_type):
    """The full objective over the same tiny forward on both sides
    (embedding rows times a matrix, policy and reference weights
    different): loss, metrics and the policy's gradients equal JAX's."""
    V, L, B, D = 11, 9, 2, 16
    rng = np.random.default_rng(2)
    pol = {"emb": rng.standard_normal((V, D)).astype(np.float32),
           "w": rng.standard_normal((D, V)).astype(np.float32) * 0.3}
    ref = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
           for k, v in pol.items()}
    ids_c, ids_r = rng.integers(0, V, (B, L)), rng.integers(0, V, (B, L))
    lab_c, lab_r = ids_c.copy(), ids_r.copy()
    lab_c[:, :2], lab_r[:, :3] = -100, -100
    batch = {"chosen_ids": ids_c, "chosen_labels": lab_c,
             "rejected_ids": ids_r, "rejected_labels": lab_r}
    kw = dict(beta=0.1, dpo_alpha=0.8, gamma=0.5, loss_type=loss_type,
              label_smoothing=0.1 if loss_type == "sigmoid" else 0.0)

    def jfwd(p, ids):
        return p["emb"][ids] @ p["w"]

    jref = {k: jnp.asarray(v) for k, v in ref.items()}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jdpo.ar_dpo_batch_loss(jfwd, p, jref, _jbatch(batch), **kw),
        has_aux=True)({k: jnp.asarray(v) for k, v in pol.items()})

    tpol = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in pol.items()}
    tref = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in ref.items()}
    loss, m = dpo.ar_dpo_batch_loss(lambda p, ids: p["emb"][ids] @ p["w"],
                                    tpol, tref, _tbatch(batch), **kw)
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5, abs=1e-6)
    assert set(m) == set(jm)
    for k in m:
        assert m[k].item() == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-6), k
    for k in pol:
        np.testing.assert_allclose(tpol[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6)
        assert tref[k].grad is None
