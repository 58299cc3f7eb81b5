"""The port's training slice (lavida_mod_tpu_torch.train) against the JAX
package's on the CPU.

  - `diffusion_loss` on a tiny LLaDA in f32 with JAX's mask injected
    (`masked_indices`): loss and every parameter's gradient, dense and
    prefix_flash attention (JAX's kernel in interpret mode), the plain head
    and the ce_chunk head, FIM on;
  - the optimizer given fixed gradients over 5 updates (15 microsteps):
    three LR groups, warmup-cosine with a floor, per-group clipping, weight
    decay, grad_accum 3 under optax.MultiSteps and multi_steps_f32: within
    1e-6 of each tensor's largest magnitude;
  - one `make_multimodal_train_step` microstep on a tiny LaViDa in the
    mixed-precision policy (f32 masters, bf16 compute), stage-1 and
    stage-2 tunables: the JAX child records its `forward_process` mask for
    the step key, the port takes it through the injection, and loss,
    trainable gradients and updated masters agree within the bands stated
    at the test, frozen leaves unchanged;
  - `forward_process` by its properties.
The JAX side runs in strict children (tests/torch_jax_strict.py), with the
vision attention through its Pallas kernel and the splice gather through
`gather_rows_ad`, as the TPU runs them (the port follows the TPU's f32
scatter-add; JAX's CPU gather would add duplicates in bf16).
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.config import (LaViDaConfig, VisionConfig,
                                         tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu_torch.convert import masters_from_jax, state_dict_from_jax
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.models.llada import LLaDA
from lavida_mod_tpu_torch.models.multimodal import (build_gather_plan,
                                                    multimodal_embeds)
from lavida_mod_tpu_torch.train import step as tstep
from lavida_mod_tpu_torch.train.loss import diffusion_loss, forward_process
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

_FLATTEN = """
def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        OUT[prefix + key] = np.asarray(jnp.asarray(leaf, jnp.float32))
"""


def _tree(out, prefix):
    """{'a/b/c': array} entries under `prefix` -> a nested dict."""
    tree = {}
    for k, v in out.items():
        if not k.startswith(prefix):
            continue
        node, parts = tree, k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(int(p) if p.isdigit() else p, {})
        node[parts[-1]] = v
    return _lists(tree)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# diffusion_loss
# ---------------------------------------------------------------------------

LOSS_CASES = {       # attention, ce_chunk, fim
    "dense": ("dense", None, False),
    "flash": ("prefix_flash", None, False),
    "dense_chunk_fim": ("dense", 64, True),
    "flash_chunk": ("prefix_flash", 64, False),
}
FIM_ID = 7
LM_LR = 1e-2


def _loss_inputs():
    rng = np.random.default_rng(0)
    B, L = 2, 150
    ids = rng.integers(0, 500, (B, L))
    ids[:, 60:70] = FIM_ID            # FIM markers among the labels
    labels = ids.copy()
    labels[0, :40], labels[1, :25] = -100, -100      # prompts
    labels[1, 140:] = -100                           # a padding tail
    return {"ids": ids, "labels": labels,
            "mask": rng.random((B, L)) < 0.5}


@pytest.fixture(scope="module")
def loss_ref(tmp_path_factory):
    return strict_jax("import jax, jax.numpy as jnp\n" + _FLATTEN + f"""
from lavida_mod_tpu.config import tiny_llada_config
from lavida_mod_tpu.models import llada as L
from lavida_mod_tpu.ops import prefix_flash as pf
from lavida_mod_tpu.train.loss import diffusion_loss
pf._INTERPRET[0] = True
cfg = tiny_llada_config()
params = L.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
flat("params/", params)
emb = L.embed_tokens(params, jnp.asarray(IN["ids"]))
OUT["emb"] = np.asarray(emb)
for name, (impl, chunk, fim) in {LOSS_CASES!r}.items():
    def f(p):
        return diffusion_loss(p, cfg, emb, jnp.asarray(IN["labels"]),
                              jax.random.PRNGKey(3),
                              masked_indices=jnp.asarray(IN["mask"]),
                              fim_id={FIM_ID} if fim else None,
                              attention_impl=impl, ce_chunk=chunk, remat=True)
    (loss, m), g = jax.value_and_grad(f, has_aux=True)(params)
    OUT[name + "loss"] = np.asarray(loss)
    OUT[name + "acc"] = np.asarray(m["acc_mask"])
    OUT[name + "nsup"] = np.asarray(m["num_supervised"])
    flat(name + "grad/", g)
from lavida_mod_tpu.config import LaViDaConfig
from lavida_mod_tpu.train.loss import forward_process
from lavida_mod_tpu.train.step import make_optimizer, make_train_step
opt = make_optimizer(lr={LM_LR}, weight_decay=0.01, warmup_steps=0,
                     total_steps=10)
key = jax.random.PRNGKey(5)
OUT["lm_mask"] = np.asarray(forward_process(key, *IN["labels"].shape)[0])
new, _, metrics = make_train_step(LaViDaConfig(llada=cfg), opt, remat=True)(
    params, opt.init(params),
    {{"inputs_embeds": emb, "labels": jnp.asarray(IN["labels"])}}, key)
flat("lm_new/", new)
OUT["lm_loss"] = np.asarray(metrics["loss"])
OUT["lm_gnorm"] = np.asarray(metrics["grad_norm"])
""", tmp_path_factory.mktemp("loss"), _loss_inputs())


def _tiny_lm(params):
    lm = LLaDA(tiny_llada_config(), "cpu", torch.float32)
    state = {k[len("llada."):]: v for k, v in
             state_dict_from_jax({"llada": params}).items()}
    lm.load_state_dict(state, strict=True)
    return lm


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_diffusion_loss_matches_jax(loss_ref, name):
    """f32: loss within 1e-5 relative, every gradient within 1e-4 of its
    largest magnitude (the prefix_flash cases hold the plain version to the
    interpret kernel, whose tolerance is 3e-4 per element)."""
    impl, chunk, fim = LOSS_CASES[name]
    lm = _tiny_lm(_tree(loss_ref, "params/"))
    inp = _loss_inputs()
    loss, m = diffusion_loss(
        lm, torch.from_numpy(loss_ref["emb"]), torch.from_numpy(inp["labels"]),
        masked_indices=torch.from_numpy(inp["mask"]),
        fim_id=FIM_ID if fim else None, attention_impl=impl, ce_chunk=chunk,
        remat=True)
    loss.backward()
    assert abs(loss.item() - float(loss_ref[name + "loss"])) \
        <= 1e-5 * abs(float(loss_ref[name + "loss"]))
    assert m["acc_mask"].item() == pytest.approx(float(loss_ref[name + "acc"]))
    assert m["num_supervised"].item() == int(loss_ref[name + "nsup"])
    want = state_dict_from_jax({"llada": _tree(loss_ref, name + "grad/")})
    grads = {f"llada.{n}": p.grad for n, p in lm.named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert _rel(g.numpy(), want[n].numpy()) < 1e-4, n


def test_lm_train_step_matches_jax(loss_ref):
    """make_train_step (the LM-only step, every leaf in the base group) in
    f32, one microstep with JAX's mask: loss within 1e-5, grad_norm within
    1e-4, the updated params within 2 lr of JAX's (one Adam step moves a
    leaf by ~lr * sign(g)) and within lr / 100 on 99.5 % of them."""
    lm = _tiny_lm(_tree(loss_ref, "params/"))
    opt = tstep.make_optimizer(lr=LM_LR, weight_decay=0.01, warmup_steps=0,
                               total_steps=10)
    state = tstep.init_train_state(lm, opt)
    assert all(state.masters[n].data_ptr() == p.data_ptr()
               for n, p in lm.named_parameters())
    step = tstep.make_train_step(None, opt, remat=True)
    m = step(state, {"inputs_embeds": torch.from_numpy(loss_ref["emb"]),
                     "labels": torch.from_numpy(_loss_inputs()["labels"])},
             masked_indices=torch.from_numpy(loss_ref["lm_mask"]))
    assert m["loss"].item() == pytest.approx(float(loss_ref["lm_loss"]),
                                             rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(
        float(loss_ref["lm_gnorm"]), rel=1e-4)
    want = state_dict_from_jax({"llada": _tree(loss_ref, "lm_new/")})
    far = total = 0
    for n, p in lm.named_parameters():
        d = (p.detach() - want[f"llada.{n}"]).abs()
        assert d.max().item() <= 2 * LM_LR * 1.001, n
        far, total = far + int((d > LM_LR / 100).sum()), total + d.numel()
    assert far <= 0.005 * total, (far, total)


def test_heads_round_as_jax_in_bf16(tmp_path):
    """The two heads round differently (loss.py:184-186 vs llada.py:
    700-708): the ce_chunk head takes a bf16 dot and then f32, the plain
    head an f32 result of the bf16 inputs.  A bf16 LLaDA on both sides:
    each port head's loss within 1e-5 of JAX's same head; and the port's
    chunk head is the loss of bf16-rounded logits, its plain head's logits
    are not rounded."""
    inp = _loss_inputs()
    ref = strict_jax("import jax, jax.numpy as jnp\n" + _FLATTEN + """
from lavida_mod_tpu.config import tiny_llada_config
from lavida_mod_tpu.models import llada as L
from lavida_mod_tpu.train.loss import diffusion_loss
from lavida_mod_tpu.train.step import cast_floating
cfg = tiny_llada_config()
params = L.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
flat("params/", params)
pb = cast_floating(params, jnp.bfloat16)
emb = L.embed_tokens(pb, jnp.asarray(IN["ids"]))
OUT["emb"] = np.asarray(emb.astype(jnp.float32))
for name, chunk in (("plain", None), ("chunk", 64)):
    loss, _ = diffusion_loss(pb, cfg, emb, jnp.asarray(IN["labels"]),
                             jax.random.PRNGKey(3),
                             masked_indices=jnp.asarray(IN["mask"]),
                             ce_chunk=chunk, remat=False)
    OUT[name] = np.asarray(loss)
""", tmp_path, inp)
    lm = _tiny_lm(_tree(ref, "params/")).to(torch.bfloat16)
    got = {}
    with torch.no_grad():
        for name, chunk in (("plain", None), ("chunk", 64)):
            got[name] = diffusion_loss(
                lm, torch.from_numpy(ref["emb"]).bfloat16(),
                torch.from_numpy(inp["labels"]),
                masked_indices=torch.from_numpy(inp["mask"]),
                ce_chunk=chunk, remat=False)[0].item()
    for name in ("plain", "chunk"):
        assert abs(got[name] - float(ref[name])) \
            <= 1e-5 * abs(float(ref[name])), name

    from lavida_mod_tpu_torch.train.loss import _head_chunk

    g = torch.Generator().manual_seed(2)
    h = torch.randn(2, 8, 64, generator=g).bfloat16()
    t = torch.randint(0, 512, (2, 8), generator=g)
    s = torch.ones(2, 8, dtype=torch.bool)
    W = lm.ff_out.weight
    exact = h.float() @ W.float().t()

    def nll(lg):
        return -torch.log_softmax(lg, -1).gather(-1, t[..., None]).sum()

    with torch.no_grad():
        n, _ = _head_chunk(h, W, t, s)
        assert n.item() == pytest.approx(
            nll(exact.bfloat16().float()).item(), rel=1e-6)
        assert n.item() != pytest.approx(nll(exact).item(), rel=1e-6)
        plain = lm.logits(h)
        assert not torch.equal(plain, plain.bfloat16().float())


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT_KW = dict(lr=1e-2, projector_lr=3e-2, vision_tower_lr=5e-3,
              weight_decay=0.1, warmup_steps=2, total_steps=6,
              min_lr_ratio=0.1, grad_clip=1.0, grad_accum=3)
# name: (shape, gradient scale): the projector's group norm is above the
# clip, the tower's below it, the LM's in between over the microsteps
OPT_LEAVES = {"llada.wte": ((6, 4), 0.3), "llada.blocks.w": ((3, 5), 0.3),
              "siglip.fc": ((4, 3), 0.01), "projector.w": ((5, 5), 2.0),
              "image_newline": ((4,), 2.0)}


def _opt_inputs():
    rng = np.random.default_rng(11)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, (s, _) in OPT_LEAVES.items()}
    grads = [{n: (sc * rng.standard_normal(s)).astype(np.float32)
              for n, (s, sc) in OPT_LEAVES.items()} for _ in range(15)]
    return params, grads


def _nest(flat):
    out = {}
    for n, v in flat.items():
        top, _, rest = n.partition(".")
        if rest:
            out.setdefault(top, {})[rest] = v
        else:
            out[top] = v
    return out


@pytest.mark.parametrize("accum", ["multisteps", "f32"])
def test_optimizer_matches_optax(accum):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    import optax
    from lavida_mod_tpu.train.step import make_freeze_optimizer as j_make

    parts = "mm_mlp_adapter,mm_vision_tower,mm_language_model"
    jopt = j_make(parts, **OPT_KW,
                  accum_dtype=jnp.float32 if accum == "f32" else None)
    topt = tstep.make_freeze_optimizer(
        parts, **OPT_KW,
        accum_dtype=torch.float32 if accum == "f32" else None)
    params, grads = _opt_inputs()
    jp = jax.tree.map(jnp.asarray, _nest(params))
    jst = jopt.init(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    tst = topt.init(tp)
    updated = []
    for g in grads:
        upd, jst = jopt.update(jax.tree.map(jnp.asarray, _nest(g)), jst, jp)
        jp = optax.apply_updates(jp, upd)
        updated.append(topt.step({n: torch.from_numpy(a) for n, a in
                                  g.items()}, tst, tp))
        ref = {n: np.asarray(v) for n, v in state_dict_flat(jp).items()}
        for n, t in tp.items():
            assert _rel(t.numpy(), ref[n]) <= 1e-6, (n, len(updated))
    assert updated == [False, False, True] * 5
    assert all(s["count"] == 5 for s in tst["groups"].values())


def state_dict_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(state_dict_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_schedule_and_per_group_clip():
    """The schedule starts at 0 and counts updates; a group is clipped by
    its own norm."""
    sched = tstep.warmup_cosine_decay_schedule(0.0, 1.0, 2, 6, 0.1)
    assert [round(sched(c), 6) for c in range(7)] == [
        0.0, 0.5, 1.0, round(0.1 + 0.9 * 0.5 * (1 + np.cos(np.pi / 4)), 6),
        0.55, round(0.1 + 0.9 * 0.5 * (1 + np.cos(3 * np.pi / 4)), 6), 0.1]
    opt = tstep.make_freeze_optimizer("mm_mlp_adapter,mm_vision_tower",
                                      lr=1.0, b1=0.0, b2=0.0,
                                      schedule="constant")
    p = {"projector.w": torch.zeros(2), "siglip.w": torch.zeros(2)}
    st = opt.init(p)
    g = {"projector.w": torch.tensor([30.0, 40.0]),
         "siglip.w": torch.tensor([0.3, -0.4])}
    opt.step(g, st, p)
    # b1 = b2 = 0: the update is -g / (|g| + eps), so clipping shows only
    # through eps; the groups' norms (50 and 0.5) are not mixed
    torch.testing.assert_close(p["projector.w"], -torch.ones(2))
    torch.testing.assert_close(p["siglip.w"], torch.tensor([-1.0, 1.0]))
    assert opt.label("llada.wte.weight") == "frozen"


# ---------------------------------------------------------------------------
# the multimodal train step
# ---------------------------------------------------------------------------

STEP_LR = 1e-3
TUNABLE = {"stage1": "mm_mlp_adapter",
           "stage2": "mm_mlp_adapter,mm_vision_tower,mm_language_model"}


def _step_cfg():
    # d_model 128: the TPU gather kernel (interpret mode) takes whole
    # 128-lane rows
    return LaViDaConfig(
        llada=tiny_llada_config(d_model=128),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                            grid_pinpoints=((56, 112), (112, 56),
                                            (112, 112))))


def _step_batch(cfg):
    rng = np.random.default_rng(5)
    S = cfg.vision.siglip.image_size
    pix = rng.standard_normal((5 + 3, 3, S, S)).astype(np.float32)
    ids = [np.concatenate([rng.integers(3, 400, 6), [-200],
                           rng.integers(3, 400, 30)]),
           np.concatenate([rng.integers(3, 400, 4), [-200],
                           rng.integers(3, 400, 20)])]
    labels = [i.copy() for i in ids]
    labels[0][:12], labels[1][:8] = -100, -100
    gather_idx, text_ids, _, labels = build_gather_plan(
        cfg, ids, [[5], [3]], [[(64, 64)], [(100, 40)]], labels, pad_to=128)
    return {"pixel_values": pix, "text_ids": text_ids,
            "gather_idx": gather_idx, "labels": labels}


@pytest.fixture(scope="module")
def step_ref(tmp_path_factory):
    cfg = _step_cfg()
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
# the vision attention and the splice gather as the TPU runs them
jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
pg.gather_rows_auto = lambda t, i: pg.gather_rows_ad(t, i, interpret=True)
cfg = LaViDaConfig(
    llada=tiny_llada_config(d_model=128),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
params = mm.init_params(cfg, jax.random.PRNGKey(0))
flat("params/", params)
batch = {{k: jnp.asarray(IN[k]) for k in
         ("pixel_values", "text_ids", "gather_idx", "labels")}}
key = jax.random.PRNGKey(7)
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
for name, parts in {TUNABLE!r}.items():
    opt = make_freeze_optimizer(parts, lr={STEP_LR}, warmup_steps=0,
                                total_steps=10)
    step = jax.jit(make_multimodal_train_step(
        cfg, opt, remat=True, compute_dtype=jnp.bfloat16))
    new, _, metrics = step(params, opt.init(params), batch, key)
    flat(name + "/new/", new)
    OUT[name + "/loss"] = np.asarray(metrics["loss"])
    OUT[name + "/grad_norm"] = np.asarray(metrics["grad_norm"])
""", tmp_path_factory.mktemp("step"), _step_batch(cfg))


def _grads_of(names, grads):
    return np.sqrt(sum(float((grads[n].astype(np.float64) ** 2).sum())
                       for n in names))


@pytest.mark.parametrize("stage", list(TUNABLE))
def test_multimodal_step_matches_jax(step_ref, stage):
    """bf16 compute on f32 masters, one microstep with JAX's mask.  Bands:
    loss within 1 %; each trainable gradient within 10 % of its largest
    magnitude (bf16 rounds at other places in the two packages; the tiny
    tower's bias gradients, sums over few rows, come to 6 %); grad_norm
    within 2 % of the JAX step's grad_norm, the global norm over every
    leaf, frozen ones included (stage 1: the frozen LLaDA and tower
    gradients are most of it); every updated master within 2 lr of JAX's
    (one Adam step moves a leaf by ~lr * sign(g), so a gradient near 0 may
    flip) and within lr / 100 on 98 % of all trainable elements; frozen
    leaves bit-identical, with no gradient left and requires_grad off after
    the step."""
    cfg = _step_cfg()
    params = _tree(step_ref, "params/")
    batch = _step_batch(cfg)
    mask = torch.from_numpy(step_ref["mask"])
    opt = tstep.make_freeze_optimizer(TUNABLE[stage], lr=STEP_LR,
                                      warmup_steps=0, total_steps=10)
    model = LaViDa.from_jax(cfg, params, "cpu")
    state = tstep.init_train_state(model, opt, torch.bfloat16,
                                   masters_from_jax(params, "cpu"))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n not in state.masters}
    assert all(not p.requires_grad for n, p in model.named_parameters()
               if n in frozen)

    # the gradients, as the step takes them
    emb = multimodal_embeds(model, torch.from_numpy(batch["pixel_values"]),
                            batch["text_ids"], batch["gather_idx"], remat=True)
    loss, _ = diffusion_loss(model.llada, emb,
                             torch.from_numpy(batch["labels"]),
                             masked_indices=mask)
    loss.backward()
    params_t = dict(model.named_parameters())
    grads = {n: params_t[n].grad.float().numpy() for n in state.masters}
    for p in model.parameters():
        p.grad = None
    want = {n: t.numpy() for n, t in
            state_dict_from_jax(_tree(step_ref, "grad/")).items()}
    for n, g in grads.items():
        if n.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax ignores a shift shared by
            # all keys): both sides are rounding noise
            scale = np.abs(want[n.replace("k_proj", "q_proj")]).max()
            assert max(np.abs(g).max(), np.abs(want[n]).max()) < 1e-3 * scale
        else:
            assert _rel(g, want[n]) < 0.1, n

    step = tstep.make_multimodal_train_step(cfg, opt, remat=True)
    metrics = step(state, batch, masked_indices=mask)
    assert abs(metrics["loss"].item() - float(step_ref[f"{stage}/loss"])) \
        < 0.01 * float(step_ref[f"{stage}/loss"])
    assert metrics["loss"].item() == pytest.approx(loss.item(), rel=1e-6)
    jnorm = float(step_ref[f"{stage}/grad_norm"])
    assert jnorm == pytest.approx(_grads_of(want, want), rel=1e-5)
    assert abs(metrics["grad_norm"].item() - jnorm) < 0.02 * jnorm
    new = state_dict_from_jax(_tree(step_ref, f"{stage}/new/"))
    far = total = 0
    for n, m in state.masters.items():
        d = np.abs(m.numpy() - new[n].numpy())
        assert d.max() <= 2 * STEP_LR * 1.001, n
        far, total = far + int((d > STEP_LR / 100).sum()), total + d.size
        assert not torch.equal(m, torch.from_numpy(params_np(params, n))), n
    assert far <= 0.02 * total, (far, total)
    for n, t in frozen.items():
        assert torch.equal(params_t[n].detach(), t), n
        assert params_t[n].grad is None and not params_t[n].requires_grad
    names = {n.split(".")[0] for n in state.masters}
    assert names == ({"projector", "image_newline"} if stage == "stage1"
                     else {"projector", "image_newline", "siglip", "llada"})


def test_masters_from_jax_defaults_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU (the tests pass "cpu")."""
    import inspect

    sig = inspect.signature(masters_from_jax)
    assert sig.parameters["device"].default == "cuda"
    out = masters_from_jax({"image_newline": np.ones(4, np.float16)},
                           "cpu")
    assert out["image_newline"].device.type == "cpu"
    assert out["image_newline"].dtype == torch.float32


def params_np(params, name):
    return state_dict_from_jax(params)[name].numpy()


def test_forward_process_properties():
    """At least one masked position per row, rate tracking p_mask, and the
    doubled batch supervises every label exactly once."""
    g = torch.Generator().manual_seed(0)
    masked, p_mask = forward_process(g, 400, 16)
    assert masked.any(dim=1).all()
    assert p_mask.shape == (400, 1) and ((p_mask > 0) & (p_mask <= 1)).all()
    rate = masked.float().mean(dim=1, keepdim=True)
    assert (rate - p_mask).abs().mean() < 0.15
    lm = LLaDA(tiny_llada_config(), "cpu", torch.float32)
    labels = torch.randint(0, 400, (3, 40), generator=g)
    labels[:, :9] = -100
    labels[2, 30:] = FIM_ID
    _, m = diffusion_loss(lm, torch.randn(3, 40, 64, generator=g), labels,
                          g, fim_id=FIM_ID)
    assert m["num_supervised"].item() == int(((labels != -100)
                                              & (labels != FIM_ID)).sum())


def test_auto_attention_is_dense_on_the_cpu(monkeypatch):
    """attention_impl="auto" on CPU tensors is the dense path: it never
    reaches prefix_flash_attention and gives dense's logits bit for bit."""
    from lavida_mod_tpu_torch.models import llada as tllada

    def no_flash(*args):
        raise AssertionError("auto reached prefix_flash on the CPU")

    g = torch.Generator().manual_seed(2)
    lm = LLaDA(tiny_llada_config(), "cpu", torch.float32)
    emb = torch.randn(2, 40, 64, generator=g)
    plen = torch.tensor([9, 0])
    dense, _ = lm.forward(emb, prefix_lengths=plen, attention_impl="dense")
    monkeypatch.setattr(tllada, "prefix_flash_attention", no_flash)
    auto, _ = lm.forward(emb, prefix_lengths=plen, attention_impl="auto")
    assert torch.equal(auto, dense)
