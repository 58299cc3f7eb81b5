"""The port's activation-checkpointing strategies, blockwise attention and
tied head against the JAX package on the CPU.

  - every remat strategy (whole_layer, nested, dots, dots_nobatch,
    one_in_2, one_in_4, an int) gives the loss and gradients of no remat
    bit for bit in f32 (`test_remat_strategies_exact` in
    tests/test_train.py asserts the same of JAX's), and the port's loss
    and gradients are JAX's within the f32 bands of test_torch_train.py;
  - `blockwise_attention` equals JAX's within 1e-5 in f32 (a prefix, key
    padding, GQA, S not a multiple of the key block), forward and VJP,
    and the model's blockwise forward equals its dense one;
  - a tied model (weight_tying: no ff_out, the head is wte's transpose)
    equals JAX's forward and `diffusion_loss` with and without ce_chunk,
    loss and gradients (`test_ce_chunk_loss_and_grads_exact(tied)`).
The card cases (`-k cuda`) hold blockwise attention and each strategy on
the card to the CPU and skip without one; the JAX package is imported
inside the CPU cases only, so the card runs this file without JAX.
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.config import tiny_llada_config
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.models.llada import (LLaDA, nested_groups,
                                               remat_plan)
from lavida_mod_tpu_torch.ops.attention import blockwise_attention
from lavida_mod_tpu_torch.train.loss import diffusion_loss

torch.set_num_threads(2)

STRATEGIES = ["whole_layer", "nested", "dots", "dots_nobatch", "one_in_2",
              "one_in_4", 2]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port_lm(cfg_kw, params):
    lm = LLaDA(tiny_llada_config(**cfg_kw), "cpu", torch.float32)
    state = {k[len("llada."):]: v for k, v in state_dict_from_jax(
        {"llada": _np_tree(params)}).items()}
    lm.load_state_dict(state, strict=True)
    return lm


def _grads(lm):
    return {n: p.grad.clone() for n, p in lm.named_parameters()
            if p.grad is not None}


@pytest.fixture(scope="module")
def remat_ref():
    """JAX's loss and gradients of (logits ** 2).mean() at n_layers 4,
    no remat (tests/test_train.py::test_remat_strategies_exact)."""
    import jax
    import jax.numpy as jnp

    from lavida_mod_tpu.config import tiny_llada_config as j_tiny
    from lavida_mod_tpu.models import llada as jl

    cfg = j_tiny(n_layers=4)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    embeds = jl.embed_tokens(params, jnp.asarray(np.arange(3, 19)[None]))

    def loss(p):
        logits, _ = jl.forward(p, cfg, embeds, remat=False)
        return (logits.astype(jnp.float32) ** 2).mean()

    value, grads = jax.value_and_grad(loss)(params)
    return params, np.array(embeds), float(value), state_dict_from_jax(
        {"llada": _np_tree(grads)})


def _port_loss(lm, embeds, remat):
    lm.zero_grad(set_to_none=True)
    logits, _ = lm(torch.from_numpy(embeds), remat=remat)
    loss = (logits.float() ** 2).mean()
    loss.backward()
    return loss.item(), _grads(lm)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_remat_strategies_exact(remat_ref, strategy):
    params, embeds, j_value, j_grads = remat_ref
    lm = _port_lm(dict(n_layers=4), params)
    base, gbase = _port_loss(lm, embeds, False)
    out, g = _port_loss(lm, embeds, strategy)
    assert out == base
    assert set(g) == set(gbase)
    for n in g:
        assert torch.equal(g[n], gbase[n]), n
    # and the port is JAX's: loss 1e-5 relative, gradients 1e-4 of max
    assert abs(out - j_value) <= 1e-5 * abs(j_value)
    for n, t in g.items():
        assert _rel(t.numpy(), j_grads[f"llada.{n}"].numpy()) < 1e-4, n


def test_remat_plan_and_groups():
    assert remat_plan(False) == ("none", 1)
    assert remat_plan("none") == ("none", 1)
    assert remat_plan(True) == ("whole_layer", 1)
    assert remat_plan("one_in_1") == ("whole_layer", 1)
    assert remat_plan("one_in_3") == ("one_in", 3)
    assert remat_plan(4) == ("one_in", 4)
    assert remat_plan("dots") == ("dots", 1)
    for bad in ("one_in_x", "layers", 2.5):
        with pytest.raises(ValueError):
            remat_plan(bad)
    # llada.py:620-622: G from (8, 4, 2, 1) with L % G == 0, L // G >= G
    assert [nested_groups(n) for n in (2, 4, 6, 12, 32, 64)] == \
        [1, 2, 2, 2, 4, 8]
    lm = LLaDA(tiny_llada_config(n_layers=4), "cpu", torch.float32)
    with pytest.raises(ValueError, match="one_in_3"):
        lm(torch.zeros(1, 4, 64), remat="one_in_3")


BW_CASES = {   # B, T, S, Hq, Hkv, kv_block, prefix lengths, valid keys
    "prefix_pad": (2, 40, 40, 4, 2, 16, [7, 0], [40, 33]),
    "one_block": (1, 24, 24, 2, 2, 1024, [5], [20]),
    "no_prefix": (2, 30, 30, 4, 4, 8, None, [30, 17]),
}


def _bw_inputs(name):
    B, T, S, Hq, Hkv, blk, plen, nvalid = BW_CASES[name]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((B, n, h, 16)).astype(np.float32)
               for n, h in ((T, Hq), (S, Hkv), (S, Hkv)))
    dout = rng.standard_normal((B, T, Hq, 16)).astype(np.float32)
    valid = np.arange(S)[None] < np.asarray(nvalid)[:, None]
    pl = None if plen is None else np.asarray(plen, np.int32)
    return q, k, v, dout, valid, pl, blk


@pytest.mark.parametrize("name", list(BW_CASES))
def test_blockwise_attention_matches_jax(name):
    import jax
    import jax.numpy as jnp

    from lavida_mod_tpu.ops.attention import blockwise_attention as j_bw

    q, k, v, dout, valid, pl, blk = _bw_inputs(name)

    def f(q, k, v):
        return j_bw(q, k, v, kv_valid=jnp.asarray(valid),
                    prefix_lengths=None if pl is None else jnp.asarray(pl),
                    kv_block=blk)

    j_out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = blockwise_attention(
        tq, tk, tv, kv_valid=torch.from_numpy(valid),
        prefix_lengths=None if pl is None else torch.from_numpy(pl),
        kv_block=blk)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5, rtol=0)
    for t, g in zip((tq, tk, tv), j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=0)


def test_blockwise_forward_matches_dense():
    """LLaDA.forward(attention_impl="blockwise") is the dense forward's
    function: logits and gradients within 1e-5 of max in f32, with the
    prefix-LM mask and a padded key block (kv_block 16 over T 37)."""
    torch.manual_seed(0)
    lm = LLaDA(tiny_llada_config(n_layers=2), "cpu", torch.float32)
    for p in lm.parameters():
        torch.nn.init.normal_(p, std=0.05)
    emb = torch.randn(2, 37, 64) * 0.5
    plen = torch.tensor([9, 20])
    out = {}
    for impl in ("dense", "blockwise"):
        lm.zero_grad(set_to_none=True)
        logits, _ = lm(emb, prefix_lengths=plen, attention_impl=impl,
                       kv_block=16, remat="whole_layer")
        (logits ** 2).mean().backward()
        out[impl] = (logits.detach(), _grads(lm))
    assert _rel(out["blockwise"][0], out["dense"][0]) < 1e-5
    for n, g in out["dense"][1].items():
        assert _rel(out["blockwise"][1][n], g) < 1e-5, n


def test_blockwise_refuses_cache_and_flash():
    lm = LLaDA(tiny_llada_config(), "cpu", torch.float32)
    with pytest.raises(ValueError, match="blockwise"):
        lm(torch.zeros(1, 4, 64), attention_impl="blockwise", use_flash=True)


@pytest.fixture(scope="module")
def tied_ref():
    """JAX, tied tiny config: logits of a forward and diffusion_loss with
    an injected mask (ce_chunk None and 32) with its gradients."""
    import jax
    import jax.numpy as jnp

    from lavida_mod_tpu.config import tiny_llada_config as j_tiny
    from lavida_mod_tpu.models import llada as jl
    from lavida_mod_tpu.train.loss import diffusion_loss as j_loss

    cfg = j_tiny(weight_tying=True)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    assert "ff_out" not in params
    B, T = 2, 100
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, T), 0,
                                        500))
    labels = ids.copy()
    labels[:, :30] = -100
    mask = np.random.default_rng(4).random((B, T)) < 0.5
    emb = jl.embed_tokens(params, jnp.asarray(ids))
    logits, _ = jl.forward(params, cfg, emb)
    out = {"logits": np.asarray(logits)}
    for ce in (None, 32):
        def f(p):
            return j_loss(p, cfg, emb, jnp.asarray(labels),
                          jax.random.PRNGKey(3), prefix_lm=True,
                          masked_indices=jnp.asarray(mask), ce_chunk=ce)
        (loss, m), g = jax.value_and_grad(f, has_aux=True)(params)
        out[ce] = (float(loss), float(m["acc_mask"]), state_dict_from_jax(
            {"llada": _np_tree(g)}))
    return params, np.array(emb), labels, mask, out


@pytest.mark.parametrize("ce", [None, 32])
def test_tied_head_matches_jax(tied_ref, ce):
    params, emb, labels, mask, ref = tied_ref
    lm = _port_lm(dict(weight_tying=True), params)
    assert lm.ff_out is None and lm.head_weight is lm.wte.weight
    with torch.no_grad():
        logits, _ = lm(torch.from_numpy(emb))
    assert _rel(logits.numpy(), ref["logits"]) < 1e-5
    loss, m = diffusion_loss(lm, torch.from_numpy(emb),
                             torch.from_numpy(labels),
                             masked_indices=torch.from_numpy(mask),
                             ce_chunk=ce, remat=True)
    loss.backward()
    j_value, j_acc, j_grads = ref[ce]
    assert abs(loss.item() - j_value) <= 1e-5 * abs(j_value)
    assert m["acc_mask"].item() == pytest.approx(j_acc)
    grads = {f"llada.{n}": g for n, g in _grads(lm).items()}
    assert set(grads) == set(j_grads)
    for n, g in grads.items():
        assert _rel(g.numpy(), j_grads[n].numpy()) < 1e-4, n
    # the chunked head is the plain head's function
    if ce is not None:
        assert abs(ref[None][0] - ref[32][0]) <= 1e-6 * abs(ref[None][0])


def test_tied_model_layouts():
    """A tied model loads from a JAX tree without ff_out, and its
    quantized layouts keep the head as wte's (as quantize_params does)."""
    import jax

    from lavida_mod_tpu.config import tiny_llada_config as j_tiny
    from lavida_mod_tpu.models import llada as jl
    from lavida_mod_tpu_torch.ops.quant import Int4Linear

    params = jl.init_params(j_tiny(weight_tying=True, d_model=128,
                                   n_heads=4, n_kv_heads=4,
                                   mlp_hidden_size=256),
                            jax.random.PRNGKey(0))
    lm = _port_lm(dict(weight_tying=True, d_model=128, n_heads=4,
                       n_kv_heads=4, mlp_hidden_size=256), params)
    x = torch.randn(1, 8, 128)
    with torch.no_grad():
        before = lm.head(x)
        lm.add_prefill_tree()
        lm.quantize(4)
        assert lm.ff_out is None and lm.prefill_head is None
        assert isinstance(lm.blocks[0].q_proj, Int4Linear)
        assert torch.equal(lm.head(x), before)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(BW_CASES))
def test_blockwise_cuda_matches_cpu(cuda, name):
    """f32 on the card (TF32 off) against the CPU: forward and VJP within
    1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout, valid, pl, blk = _bw_inputs(name)
    res = {}
    for dev in ("cpu", cuda):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in (q, k, v)]
        out = blockwise_attention(
            *ts, kv_valid=torch.from_numpy(valid).to(dev),
            prefix_lengths=None if pl is None
            else torch.from_numpy(pl).to(dev), kv_block=blk)
        out.backward(torch.from_numpy(dout).to(dev))
        res[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in ts]
    for a, b in zip(res["cpu"], res[str(cuda)]):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("strategy", STRATEGIES + ["none"])
def test_remat_cuda_matches_cpu(cuda, strategy):
    """A tiny LLaDA's loss and gradients under each strategy on the card
    (f32, TF32 off) within 1e-5 / 1e-4 of max of the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    ref = LLaDA(tiny_llada_config(n_layers=4), "cpu", torch.float32)
    for p in ref.parameters():
        torch.nn.init.normal_(p, std=0.05)
    emb = torch.randn(2, 40, 64) * 0.5
    res = {}
    for dev in ("cpu", cuda):
        lm = LLaDA(tiny_llada_config(n_layers=4), dev, torch.float32)
        lm.load_state_dict(ref.state_dict())
        logits, _ = lm(emb.to(dev), prefix_lengths=torch.tensor(
            [7, 19], device=dev), attention_impl="dense", remat=strategy)
        loss = (logits ** 2).mean()
        loss.backward()
        res[str(dev)] = (loss.item(), {n: g.cpu()
                                       for n, g in _grads(lm).items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res[str(cuda)]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for n in g_cpu:
        assert _rel(g_gpu[n], g_cpu[n]) < 1e-4, n
