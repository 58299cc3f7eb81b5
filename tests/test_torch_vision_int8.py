"""The int8 SigLIP tower in the port (`SigLIP.quantize_tower`, the tower's
`act_int8`, `multimodal_embeds(vision_act_int8=)`) against the JAX package
(siglip.py:69-81, :160-178, multimodal.py:346-410) on the CPU:
  - `quantize_tower` bit-equal to JAX's: every layer's int8 codes and
    per-(layer, out) scales, the biases, embeddings and norms untouched;
    and the JAX tree's int8 tower carried by convert.py / LaViDa.from_jax
    onto the same modules;
  - the int8 tower with int8 activations against JAX's CPU
    `linear_act_int8` path (quant.py:195-230): in f32 within 1e-4 of max
    |JAX feature| (the activation codes are the same but where an f32
    difference of the other ops moves a rounding), in bf16 with XLA's
    excess precision off (tests/torch_jax_strict.py) within 5e-2 (the
    float bf16 tower is itself 1.0e-2 from JAX's there, the patch
    embedding's and the attention's summation orders, and the int8
    activations move a code wherever such a difference crosses a rounding
    boundary: 2.5e-2 measured); the weight-only int8 tower within 1e-5 in
    f32;
  - the splice with `vision_act_int8` within 1e-4 of JAX's in f32;
  - act_int8 with the fused ViT MLP raises, as JAX's assert does.
A card case (skipped without CUDA) runs the int8 tower through #3 and
counts its launches: python -m pytest --noconftest -k cuda
tests/test_torch_vision_int8.py
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models import multimodal as jmm
from lavida_mod_tpu.models import siglip as jsig
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.models import multimodal as tmm
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.ops.quant import Int8Linear

torch.set_num_threads(2)

CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def _scaled(p, scale=10.0):
    return jax.tree.map(lambda a: a * scale if a.ndim >= 2 else a, p)


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the port model from them, float tower)."""
    p = JLaViDa.random_init(CFG, 0, jnp.float32).params
    p["siglip"] = _scaled(p["siglip"], 5.0)
    p = jax.tree.map(np.asarray, p)
    return p, LaViDa.from_jax(CFG, p, "cpu")


def _views(seed, n=5):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 56, 56)).astype(np.float32)


def _int8_model(p):
    m = LaViDa.from_jax(CFG, p, "cpu")
    m.siglip.quantize_tower()
    return m


def test_quantize_tower_bit_equal_to_jax(pair):
    p, _ = pair
    jq = jsig.quantize_tower(jax.tree.map(jnp.asarray, p["siglip"]))
    m = _int8_model(p)
    for i, layer in enumerate(m.siglip.layers):
        for n in LINEARS:
            lin = getattr(layer, n)
            assert isinstance(lin, Int8Linear)
            np.testing.assert_array_equal(
                lin.weight_q.numpy(), np.asarray(jq["layers"][n]["kernel_q"][i]).T)
            np.testing.assert_array_equal(
                lin.scale.numpy(), np.asarray(jq["layers"][n]["scale"][i]))
            np.testing.assert_array_equal(
                lin.bias.detach().numpy(), np.asarray(jq["layers"][n]["bias"][i]))
        for n in ("ln1", "ln2"):
            np.testing.assert_array_equal(
                getattr(layer, n).weight.detach().numpy(),
                np.asarray(jq["layers"][n]["weight"][i]))
    np.testing.assert_array_equal(m.siglip.patch_embed.weight.detach().numpy(),
                                  np.asarray(jq["patch_embed"]["kernel"]).T)
    # the JAX tree's int8 tower converts onto the same modules
    jp = dict(p, siglip=jax.tree.map(np.asarray, jq))
    c = LaViDa.from_jax(CFG, jp, "cpu")
    for a, b in zip(c.siglip.state_dict().items(),
                    m.siglip.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("act_int8", [True, False])
def test_int8_tower_f32_matches_jax(pair, act_int8):
    p, _ = pair
    jq = jsig.quantize_tower(jax.tree.map(jnp.asarray, p["siglip"]))
    m = _int8_model(p)
    pix = _views(1)
    want = np.asarray(jsig.forward(jq, CFG.vision.siglip, jnp.asarray(pix),
                                   act_int8=act_int8))
    with torch.no_grad():
        got = m.siglip(torch.from_numpy(pix), act_int8=act_int8).numpy()
    band = 1e-4 if act_int8 else 1e-5
    assert np.abs(got - want).max() < band * np.abs(want).max()
    if act_int8:
        with torch.no_grad():
            plain = m.siglip(torch.from_numpy(pix)).numpy()
        assert np.abs(got - plain).max() > 10 * band * np.abs(want).max()


def test_int8_tower_bf16_matches_jax(pair, tmp_path):
    from torch_jax_strict import strict_jax

    p, _ = pair
    sp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                           np.float32), p["siglip"])
    pix = _views(2)
    flat = {}
    for path, a in jax.tree_util.tree_leaves_with_path(sp):
        flat["s/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path)] = a
    ref = strict_jax("""
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import tiny_siglip_config
from lavida_mod_tpu.models import siglip as jsig
tree = {}
for key, a in IN.items():
    if key.startswith("s/"):
        node, parts = tree, key[2:].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = jnp.asarray(a, jnp.bfloat16)
q = jsig.quantize_tower(tree)
out = jsig.forward(q, tiny_siglip_config(), jnp.asarray(IN["pix"]),
                   act_int8=True)
OUT["out"] = np.asarray(out.astype(jnp.float32))
""", tmp_path, {"pix": pix, **flat})
    m = _int8_model(dict(p, siglip=sp))
    m.to(torch.bfloat16)
    with torch.no_grad():
        got = m.siglip(torch.from_numpy(pix), act_int8=True).float().numpy()
    want = ref["out"]
    assert np.abs(got - want).max() < 5e-2 * np.abs(want).max()


def test_splice_with_vision_act_int8_matches_jax(pair):
    p, _ = pair
    jp = jax.tree.map(jnp.asarray, p)
    jp["siglip"] = jsig.quantize_tower(jp["siglip"])
    m = _int8_model(p)
    ids = np.concatenate([np.arange(5, 9), [-200], np.arange(9, 20)])
    views = _views(3)
    size = (100, 60)
    gidx, text_ids, _, _ = tmm.build_gather_plan(
        m.cfg, batch_input_ids=[ids], batch_n_views=[[5]],
        batch_image_sizes=[[size]])
    want = np.asarray(jmm.multimodal_embeds(
        jp, CFG, jnp.asarray(views), jnp.asarray(text_ids),
        jnp.asarray(gidx), vision_act_int8=True))
    with torch.no_grad():
        got = tmm.multimodal_embeds(m, torch.from_numpy(views), text_ids,
                                    gidx, vision_act_int8=True).numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_act_int8_with_fused_mlp_raises(pair):
    _, m = pair
    with pytest.raises(ValueError, match="act_int8"):
        m.siglip(torch.from_numpy(_views(0, 1)), fused_mlp=True,
                 act_int8=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_int8_tower_through_w8a8_on_cuda(cuda):
    """On the card every linear of a bf16 int8 tower (hd 16, which #1
    takes) launches #3, 6 per layer, and the features stay within 2e-2 of
    the same tower's on the CPU."""
    from lavida_mod_tpu_torch.models.siglip import SigLIP
    from lavida_mod_tpu_torch.ops import w8a8

    cfg = tiny_siglip_config(hidden_size=64, intermediate_size=128)
    g = torch.Generator().manual_seed(0)
    tower = SigLIP(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for prm in tower.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.1)
    tower.to(torch.bfloat16)      # before quantizing: .to() casts buffers
    tower.quantize_tower()
    pix = torch.from_numpy(_views(4))
    with torch.no_grad():
        cpu = tower(pix, act_int8=True).float()
        tower.to(cuda)
        n0 = w8a8.w8a8_matmul.launches
        got = tower(pix.to(cuda), act_int8=True).float().cpu()
    assert w8a8.w8a8_matmul.launches - n0 == 6 * len(tower.layers)
    assert (got - cpu).abs().max() < 2e-2 * cpu.abs().max()
