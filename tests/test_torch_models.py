"""Port models (lavida_mod_tpu_torch.models) against the JAX package's
models on the CPU, with weights carried over by convert.py.

Vision side (SigLIP tower, projector, encode_views, the splice) at atol
1e-5 in f32; the host planners (merge_anyres_indices, build_gather_plan)
exactly; LLaDA (tiny_llada_config: 2 layers, GQA, blocks unstacked) at
atol 1e-4: the full forward's logits, the prefill's K/V written into
[P + G] buffers, and one decode step's logits.  LLaDA weights are scaled
x10 from the JAX init (std 0.02 -> 0.2) so its activations and logits
spread and a wrong op cannot hide under the tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import multimodal as jmm
from lavida_mod_tpu.models import projector as jproj
from lavida_mod_tpu.models import siglip as jsig
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.convert import state_dict_from_jax
from lavida_mod_tpu_torch.models import multimodal as tmm
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.models.llada import LLaDA

torch.set_num_threads(2)

CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))


def _scaled(params, scale=10.0):
    return jax.tree.map(lambda a: a * scale if a.ndim >= 2 else a, params)


@pytest.fixture(scope="module")
def pair():
    """(JAX params with unstacked LLaDA blocks, the port model)."""
    p = JLaViDa.random_init(CFG, 0, jnp.float32).params
    p["llada"] = jl.unstack_blocks(_scaled(p["llada"]))
    return p, LaViDa.from_jax(CFG, jax.tree.map(np.asarray, p), "cpu")


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _views(seed, n=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3, 56, 56)).astype(np.float32)


def test_siglip_tower(pair):
    p, m = pair
    pix = _views(0)
    _close(m.siglip(torch.from_numpy(pix)),
           jsig.forward(p["siglip"], CFG.vision.siglip, jnp.asarray(pix)),
           atol=1e-5)


def test_siglip_rejects_other_resolutions(pair):
    """Another square patch grid (70^2: 5 x 5 against the 4 x 4 table)
    now runs with the bicubic table, as JAX's tower; a grid that is no
    square is still refused."""
    p, m = pair
    pix = np.random.default_rng(3).standard_normal((2, 3, 70, 70)).astype(
        np.float32)
    _close(m.siglip(torch.from_numpy(pix)),
           jsig.forward(p["siglip"], CFG.vision.siglip, jnp.asarray(pix)),
           atol=1e-5)
    with pytest.raises(ValueError, match="no square grid"):
        m.siglip(torch.zeros(1, 3, 70, 56))


def test_projector(pair):
    p, m = pair
    x = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(
        np.float32)
    _close(m.projector(torch.from_numpy(x)),
           jproj.forward(p["projector"], "mlp2x_gelu", jnp.asarray(x)),
           atol=1e-5)


def test_encode_views(pair):
    p, m = pair
    pix = _views(2, 3)
    _close(tmm.encode_views(m, torch.from_numpy(pix)),
           jmm.encode_views(p, CFG, jnp.asarray(pix)), atol=1e-5)


@pytest.mark.parametrize("cfg", [CFG, LaViDaConfig()],
                         ids=["tiny", "lavida_hd"])
@pytest.mark.parametrize("size", [(100, 60), (60, 100), (640, 640),
                                  (1100, 380), (56, 56)])
def test_merge_anyres_indices(cfg, size):
    from lavida_mod_tpu.data.anyres import anyres_grid_shape

    nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints,
                               cfg.vision.siglip.image_size)
    g = -(-cfg.vision.siglip.num_patches_per_side
          // cfg.vision.spatial_pool_stride)
    for n_views in (1, 1 + nw * nh):
        args = (size, cfg.vision, n_views, g, 2, 999)
        np.testing.assert_array_equal(tmm.merge_anyres_indices(*args),
                                      jmm.merge_anyres_indices(*args))


@pytest.mark.parametrize("pad", [None, (96, False), (128, True)])
def test_build_gather_plan(pad):
    ids = [np.array([5, 6, -200, 7, 8, 9]),
           np.array([-200, 3, 4, -200, 11])]
    n_views = [[5], [3, 1]]
    sizes = [[(100, 60)], [(120, 40), (56, 56)]]
    labels = [np.arange(6), np.arange(5) + 100]
    kw = {} if pad is None else dict(pad_to=pad[0], pad_front=pad[1])
    got = tmm.build_gather_plan(CFG, ids, n_views, sizes, labels, **kw)
    ref = jmm.build_gather_plan(CFG, ids, n_views, sizes, labels, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_multimodal_embeds(pair):
    p, m = pair
    ids = np.array([5, 6, -200, 7, 8, 9])
    pix = _views(3)
    idx, text_ids, _, _ = tmm.build_gather_plan(CFG, [ids], [[5]],
                                                [[(100, 60)]], pad_to=64,
                                                pad_front=True)
    _close(tmm.multimodal_embeds(m, torch.from_numpy(pix), text_ids, idx),
           jmm.multimodal_embeds(p, CFG, jnp.asarray(pix),
                                 jnp.asarray(text_ids), jnp.asarray(idx)),
           atol=1e-5)


@pytest.fixture(scope="module")
def lm():
    """(JAX LLaDA params, unstacked and scaled; the port LLaDA)."""
    cfg = CFG.llada
    p = _scaled(jl.unstack_blocks(jl.init_params(cfg,
                                                 jax.random.PRNGKey(1))))
    sd = state_dict_from_jax({"llada": jax.tree.map(np.asarray, p)})
    m = LLaDA(cfg, "cpu")
    m.load_state_dict({k[len("llada."):]: v for k, v in sd.items()})
    return p, m.eval()


def _embeds(seed, B, T, D=64):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32)


@pytest.mark.parametrize("use_flash,masked", [(False, False), (False, True),
                                              (True, True)])
def test_llada_full_forward_logits(lm, use_flash, masked):
    p, m = lm
    x = _embeds(0, 2, 11)
    sv = None
    if masked:
        sv = np.ones((2, 11), bool)
        sv[1, :3] = False
    lt, ct = m(torch.from_numpy(x), use_cache=True, use_flash=use_flash,
               self_valid=None if sv is None else torch.from_numpy(sv))
    lj, cj = jl.forward(p, CFG.llada, jnp.asarray(x), use_cache=True,
                        use_flash=use_flash,
                        self_valid=None if sv is None else jnp.asarray(sv))
    assert lt.dtype == torch.float32
    _close(lt, lj, atol=1e-4)
    for li, (k, v) in enumerate(ct):
        _close(k, cj["k"][li], atol=1e-4)
        _close(v, cj["v"][li], atol=1e-4)


@pytest.mark.parametrize("front_pad", [0, 5])
def test_llada_prefill_then_decode(lm, front_pad):
    """Prefill with kv_write_index=0 into [P+G] buffers through the
    segment-masked attention, then one write-index decode step."""
    p, m = lm
    cfg = CFG.llada
    B, P, G = 1, 19, 8
    Hkv, hd = cfg.effective_n_kv_heads, cfg.head_dim
    prefix = _embeds(1, B, P)
    pv = kvv = None
    if front_pad:
        pv = np.arange(P)[None] >= front_pad
        kvv = np.concatenate([pv, np.ones((B, G), bool)], axis=1)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731

    cache_t = [(torch.zeros(B, P + G, Hkv, hd), torch.zeros(B, P + G, Hkv,
                                                            hd))
               for _ in range(cfg.n_layers)]
    ht, _ = m(torch.from_numpy(prefix), kv_cache=cache_t, kv_write_index=0,
              kv_valid=t(kvv), self_valid=t(pv), use_cache=True,
              return_logits=False, use_flash=True)
    z = jnp.zeros((B, P + G, Hkv, hd))
    hj, cache_j = jl.forward(
        p, cfg, jnp.asarray(prefix), kv_cache=[(z, z)] * cfg.n_layers,
        kv_write_index=jnp.asarray(0, jnp.int32), kv_valid=j(kvv),
        self_valid=j(pv), use_cache=True, return_logits=False,
        use_flash=True)
    _close(ht, hj, atol=1e-4)
    for (kt, vt), (kj, vj) in zip(cache_t, cache_j):
        _close(kt, kj, atol=1e-4)
        _close(vt, vj, atol=1e-4)

    ids = np.random.default_rng(2).integers(0, 500, (B, G))
    pos = np.arange(P, P + G)
    lt, _ = m(m.embed_tokens(torch.from_numpy(ids)),
              positions=torch.from_numpy(pos), kv_cache=cache_t,
              kv_valid=t(kvv), kv_write_index=P, use_cache=True)
    lj, cache_j = jl.forward(
        p, cfg, jl.embed_tokens(p, jnp.asarray(ids)),
        positions=jnp.asarray(pos), kv_cache=cache_j, kv_valid=j(kvv),
        kv_write_index=P, use_cache=True)
    _close(lt, lj, atol=1e-4)
    for (kt, _), (kj, _) in zip(cache_t, cache_j):
        _close(kt, kj, atol=1e-4)


def test_convert_stacked_equals_unstacked():
    p = jax.tree.map(np.asarray, JLaViDa.random_init(CFG, 3,
                                                     jnp.float32).params)
    stacked = state_dict_from_jax(p)
    p["llada"] = jax.tree.map(np.asarray, jl.unstack_blocks(p["llada"]))
    unstacked = state_dict_from_jax(p)
    assert stacked.keys() == unstacked.keys()
    assert set(stacked) == set(LaViDa(CFG, device="meta").state_dict())
    for k in stacked:
        assert torch.equal(stacked[k], unstacked[k]), k
    # [in, out] kernels become [out, in] nn.Linear weights
    assert torch.equal(stacked["llada.ff_out.weight"],
                       torch.from_numpy(p["llada"]["ff_out"]["kernel"].T))


@pytest.mark.parametrize("leaf", ["kernel_q", "kernel_p4", "lora_a",
                                  "mystery"])
def test_convert_raises_on_unmapped_leaves(leaf):
    """Quantized leaves outside the quantized layout, unknown names and a
    malformed LoRA factor (a lone int8 lora_a) raise naming the leaf; a
    well-formed LoRA triple carries across."""
    p = jax.tree.map(np.asarray, JLaViDa.random_init(CFG, 3,
                                                     jnp.float32).params)
    p["llada"] = jl.unstack_blocks(p["llada"])
    if leaf == "lora_a":
        good = jax.tree.map(lambda a: a, p)
        q = good["llada"]["blocks"][1]["q_proj"]
        q.update(lora_a=np.ones((64, 4), np.float32),
                 lora_b=np.ones((4, 64), np.float32),
                 lora_scale=np.float32(2.0))
        assert state_dict_from_jax(good)[
            "llada.blocks.1.q_proj.lora_b"].shape == (4, 64)
    p["llada"]["blocks"][1]["q_proj"][leaf] = np.zeros((4,), np.int8)
    with pytest.raises(ValueError, match="q_proj"):
        state_dict_from_jax(p)


@pytest.mark.parametrize("kw", [dict(block_type="parallel"),
                                dict(activation="tanh"),
                                dict(layer_norm_type="batch")])
def test_unsupported_llada_configs_raise(kw):
    """The port refuses what the JAX forward cannot run either (another
    block type, activation or norm type); the options it does run (the
    sequential block with any activation, input_emb_norm,
    attention_layer_norm, ...) are held to it in test_torch_ar.py."""
    with pytest.raises(NotImplementedError):
        LLaDA(tiny_llada_config(**kw), device="meta")


def test_random_init_is_seeded():
    a = LaViDa.random_init(CFG, 7, torch.float32, "cpu").state_dict()
    b = LaViDa.random_init(CFG, 7, torch.float32, "cpu").state_dict()
    c = LaViDa.random_init(CFG, 8, torch.float32, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "llada.blocks.0.q_proj.weight"
    assert not torch.equal(a[w], c[w])
    assert abs(a[w].std().item() - 0.02) < 0.005
    assert torch.equal(a["llada.ln_f.weight"], torch.ones(64))
    assert torch.equal(a["siglip.layers.0.fc1.bias"], torch.zeros(64))


def test_llama_ffn_rounds_like_jax_in_bf16(tmp_path):
    """The llama block's SwiGLU takes jax.nn.silu's op order in bf16
    (ops/activations.silu), not PyTorch's fused F.silu, which rounds once.
    A one-layer bf16 LLaDA whose attention weights are zero and whose FFN
    linears are identities makes every product exact, so the block is
    x + silu(h) * h with h = rmsnorm(x): bit-exact with JAX without
    excess precision (tests/torch_jax_strict.py); F.silu differs there in
    11 % of the elements."""
    from torch_jax_strict import strict_jax

    code = """
import jax, jax.numpy as jnp, numpy as np
from lavida_mod_tpu.config import tiny_llada_config
from lavida_mod_tpu.models import llada as jl
cfg = tiny_llada_config(d_model=64, n_heads=4, n_kv_heads=4,
                        mlp_hidden_size=64, n_layers=1)
p = jl.unstack_blocks(jl.init_params(cfg, jax.random.PRNGKey(0),
                                     jnp.bfloat16))
eye = jnp.eye(64, dtype=jnp.bfloat16)
b = p["blocks"][0]
for n in ("q_proj", "k_proj", "v_proj", "attn_out"):
    b[n] = {"kernel": jnp.zeros_like(b[n]["kernel"])}
for n in ("ff_proj", "up_proj", "ff_out"):
    b[n] = {"kernel": eye}
"""
    x = (torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(0))
         * 3).bfloat16()
    ref = strict_jax(code + """
h, _ = jl.forward(p, cfg, jnp.asarray(IN["x"], jnp.bfloat16),
                  return_logits=False)
OUT["h"] = np.asarray(h.astype(jnp.float32))
""", tmp_path, {"x": x.float().numpy()})
    ns = {}
    exec(code, ns)
    m = LLaDA(ns["cfg"], "meta")
    sd = state_dict_from_jax({"llada": jax.tree.map(np.asarray, ns["p"])})
    m.load_state_dict({k[len("llada."):]: v for k, v in sd.items()},
                      assign=True)
    with torch.no_grad():
        h, _ = m(x, return_logits=False)
    np.testing.assert_array_equal(h.float().numpy(), ref["h"])
