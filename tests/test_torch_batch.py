"""Batched int4 serving as a whole -- the path of the serve worker's
`--int4 --decode-batch N [--kv8]` and of bench.py's `--batch` -- against
the JAX package on the CPU.

The tiny model: a 128-wide SigLIP, so the JAX package's auto policy runs
the fused ViT-MLP kernel in `encode_prompt` (`fused_mlp_ok`), and a
512-wide LLaDA with its weights x4 (so the tokens vary), put in
`to_serving_layout("int4", fuse=False)`: llama blocks whose seven int4
linears run unfused, as the worker chooses for a decode batch > 1.  The
traffic: requests with different image sizes and prompt lengths, so the
front-padding to the 128 bucket engages.

The JAX side runs in a strict child (tests/torch_jax_strict.py) with its
Pallas kernels in interpret mode (FORCE_FUSED_INTERPRET for the fused
int4 head, KV8._INTERPRET for the int8 cache, the vision attention
through its kernel as on the TPU): per-request `encode_prompt`, the
front-pad of adapter.py:258-267, then `diffusion.generate` (kv8 off and
on) or, at B = 5, `generate_chunked_prefill` with chunk 2, all with the
flash prefill the adapter uses on the TPU.  The port runs
`eval.adapter.generate_batch`.  Each case states its token agreement and
passes the teacher-forced per-step check (`teacher_forced`: from JAX's
prefix and each recorded token buffer, the port's logits within 5 % and
its commits JAX's, but for counted near-ties).  JAX's per-step reference
prefills the whole batch in one call, at B = 5 too: JAX's CPU cache
depends on how many rows one prefill call holds (XLA compiles the
prefill, its interpret-mode kernels included, per row count and sums in
another order: its chunk-2 cache of the same five rows differs from its
one-call cache by up to 0.63 of a largest |k| of 33 at the last layer),
while the port's chunked cache is bit-equal to its one-call cache, which
the chunked case asserts.  The port's own batch prefix equals JAX's but
for under 1 % of its elements, each within a bf16 rounding of the largest
(the fused ViT-MLP's dot products sum in another order); from there the
free-running tokens drift apart at near-ties, so their agreement is
printed, not held.
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.config import GenerationConfig, as_port_config
from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape
from lavida_mod_tpu_torch.eval.adapter import generate_batch
from lavida_mod_tpu_torch.models import multimodal
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.ops import quant as tq
from torch_jax_strict import JAX_STEPS, strict_jax, teacher_forced

torch.set_num_threads(2)

JAX_MODEL = """
import jax, jax.numpy as jnp
from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa

CFG = LaViDaConfig(
    llada=tiny_llada_config(d_model=512, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=1024),
    vision=VisionConfig(
        siglip=tiny_siglip_config(hidden_size=128, intermediate_size=200),
        mm_hidden_size=128,
        grid_pinpoints=((56, 112), (112, 56), (112, 112))))

def jax_model():
    jm = JLaViDa.random_init(CFG, 0, jnp.bfloat16)
    jm.params["llada"] = jax.tree.map(
        lambda a: a * 4.0 if a.ndim >= 2 else a, jm.params["llada"])
    return jm.to_serving_layout("int4", fuse=False)
"""

GEN = dict(max_new_tokens=32, block_length=32, step_per_block=16,
           prefix_lm=True, remasking="low_confidence")
SIZES = [(100, 60), (60, 100), (112, 112), (50, 50), (120, 40)]
TEXT = [6, 9, 4, 7, 5]
# (name, batch size, kv8, chunk)
CASES = [("b3", 3, False, None), ("b3_kv8", 3, True, None),
         ("b5_chunked", 5, False, 2)]


def _jax_model():
    ns = {}
    exec(JAX_MODEL, ns)
    return ns["jax_model"](), ns["CFG"]


def _requests(n):
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        nw, nh = anyres_grid_shape(SIZES[i], ((56, 112), (112, 56),
                                               (112, 112)), 56)
        views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(
            np.float32)
        text = rng.integers(3, 400, size=TEXT[i])
        out.append((np.concatenate([text[:2], [-200], text[2:]]), [views],
                    [SIZES[i]]))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    jm, _ = _jax_model()
    tm = LaViDa.from_jax(jm.cfg, jax.tree.map(np.asarray, jm.params), "cpu")
    reqs = _requests(5)
    inputs = {}
    for i, (ids, views, _) in enumerate(reqs):
        inputs[f"ids{i}"], inputs[f"views{i}"] = ids, views[0]
    ref = strict_jax(JAX_MODEL + JAX_STEPS + f"""
from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.generation import diffusion
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.ops import kv8_attention as KV8
from lavida_mod_tpu.ops.short_attention import short_attention

jl.FORCE_FUSED_INTERPRET = True
KV8._INTERPRET[0] = True
jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
jm = jax_model()
assert jm._vision_fused_mlp()
lc = jm.cfg.llada
gen = GenerationConfig(**{GEN!r})
sizes = {SIZES!r}

def batch(n):
    pre = [jm.encode_prompt(IN[f"ids{{i}}"], [IN[f"views{{i}}"]],
                            [sizes[i]])[0] for i in range(n)]
    Pb = max(-(-p.shape[0] // 128) * 128 for p in pre)
    out = jnp.zeros((n, Pb, pre[0].shape[-1]), pre[0].dtype)
    valid = np.zeros((n, Pb), bool)
    for b, p in enumerate(pre):
        out = out.at[b, Pb - p.shape[0]:].set(p)
        valid[b, Pb - p.shape[0]:] = True
    return out, jnp.asarray(valid)

for name, n, kv8, chunk in {CASES!r}:
    prefix, valid = batch(n)
    if chunk:
        OUT[name + "/tokens"] = diffusion.generate_chunked_prefill(
            jm.params["llada"], lc, prefix, gen, chunk=chunk,
            prefix_valid=valid, use_flash_prefill=True, kv8=kv8)
    else:
        OUT[name + "/tokens"] = diffusion.generate(
            jm.params["llada"], lc, prefix, gen, prefix_valid=valid,
            kv8=kv8, use_flash_prefill=True)
    # the per-step reference prefills all n rows at once, chunked case too:
    # JAX's own cache depends on how many rows one prefill call holds (XLA
    # compiles each row count apart), the port's does not (checked below)
    OUT[name + "/xs"], OUT[name + "/logits"] = jax_steps(
        jm.params["llada"], lc, prefix, gen, prefix_valid=valid, kv8=kv8)
    if chunk:
        # how far JAX's chunked K cache lies from its one-call one, by layer
        P, G = prefix.shape[1], gen.max_new_tokens
        Hkv, hd = lc.effective_n_kv_heads, lc.head_dim
        starts = list(range(0, n - chunk + 1, chunk))
        if starts[-1] + chunk < n:
            starts.append(n - chunk)
        cc = diffusion._alloc_kv_buffers(lc.n_layers, n, P + G, Hkv, hd,
                                         prefix.dtype)
        for lo in starts:
            cc = diffusion._chunk_prefill_prealloc(
                cc, jm.params["llada"], lc, prefix[lo:lo + chunk],
                valid[lo:lo + chunk], jnp.int32(lo), True)
        z = jnp.zeros((n, P + G, Hkv, hd), prefix.dtype)
        _, uc = jl.forward(
            jm.params["llada"], lc, prefix, kv_cache=[(z, z)] * lc.n_layers,
            kv_write_index=jnp.asarray(0, jnp.int32),
            kv_valid=jnp.concatenate([valid, jnp.ones((n, G), bool)], 1),
            self_valid=valid, use_cache=True, return_logits=False,
            use_flash=True)
        f32 = lambda a: a[0].astype(jnp.float32)
        OUT[name + "/cache_gap"] = np.array(
            [float(jnp.abs(f32(a) - f32(b)).max()) for a, b in zip(cc, uc)])
        OUT[name + "/cache_max"] = np.array(
            [float(jnp.abs(f32(b)).max()) for b in uc])
    OUT[name + "/prefix"] = np.asarray(prefix.astype(jnp.float32))
    OUT[name + "/valid"] = np.asarray(valid)
""", tmp_path_factory.mktemp("batch"), inputs, timeout=1200)
    return tm, reqs, ref


def test_model_is_the_batched_int4_layout(setup):
    tm, _, _ = setup
    blk = tm.llada.blocks[0]
    assert tm.cfg.llada.block_type == "llama" and not tm.mixed
    assert all(isinstance(getattr(blk, n), tq.Int4Linear)
               for n in blk.linear_names)
    assert not blk.fused_plan(96, act_int8=False)
    assert tm.llada.head_fusable(96) and not tm.llada.head_fusable(160)
    assert tm._vision_fused_mlp() and tm.siglip.fused_mlp_ok()


@pytest.mark.parametrize("name,n,kv8,chunk", CASES)
def test_generate_batch_against_jax(setup, name, n, kv8, chunk):
    tm, reqs, ref = setup
    gen = GenerationConfig(**GEN)
    got, walls = generate_batch(tm, reqs[:n], gen, kv8=kv8)
    want = ref[name + "/tokens"]
    mask = tm.cfg.llada.mask_token_id
    assert got.shape == want.shape == (n, 32) and (got != mask).all()
    assert set(walls) == {"encode", "generate"}
    assert len(set(want.ravel().tolist())) >= 8, "degenerate"
    valid = torch.from_numpy(ref[name + "/valid"])
    assert not valid.all(), "no front-padding"
    # the port's own batch prefix
    want_prefix = torch.from_numpy(ref[name + "/prefix"])
    prefix = _batch_prefix(tm, reqs[:n]).float()
    assert prefix.shape == want_prefix.shape
    off = prefix != want_prefix
    assert off.float().mean() < 0.01, off.sum()
    assert (prefix - want_prefix).abs().max() <= \
        2 ** -7 * want_prefix.abs().max()
    if chunk:
        # the port's chunked prefill (the last chunk overlapping) writes the
        # cache its one-call prefill writes, bit for bit
        from lavida_mod_tpu_torch.generation import diffusion as td

        args = (tm.llada, want_prefix.bfloat16(), 32, valid)
        for (k1, v1), (k2, v2) in zip(td.prefill_cache(*args, chunk=chunk),
                                      td.prefill_cache(*args)):
            assert torch.equal(k1, k2) and torch.equal(v1, v2)
    ties = teacher_forced(tm, want_prefix.bfloat16(), gen, ref[name + "/xs"],
                          ref[name + "/logits"], prefix_valid=valid, kv8=kv8,
                          chunk=chunk)
    agree = float((got == want).mean())
    print(f"{name}: tokens agree with JAX {agree:.3f} (exact: "
          f"{agree == 1.0}); prefix elements off {int(off.sum())}; "
          f"near-tie exceptions of the teacher-forced steps (step, row, "
          f"gap, bound): {ties}")
    if chunk:
        print(f"{name}: JAX's chunk-{chunk} K cache against its one-call "
              f"cache, max |diff| by layer "
              f"{ref[name + '/cache_gap'].tolist()} (max |k| "
              f"{ref[name + '/cache_max'].tolist()})")


def _batch_prefix(tm, reqs):
    """The front-padded batch prefix generate_batch builds."""
    pre = [tm.encode_prompt(ids, views, sizes)[0] for ids, views, sizes
           in reqs]
    Pb = max(-(-p.shape[0] // 128) * 128 for p in pre)
    out = pre[0].new_zeros(len(pre), Pb, pre[0].shape[-1])
    for b, p in enumerate(pre):
        out[b, Pb - p.shape[0]:] = p
    return out


@pytest.mark.parametrize("fused_mlp", [False, True])
def test_splice_paths_agree(setup, fused_mlp):
    """encode_image + splice_embeddings (encode_prompt) equals the
    one-gather splice of generate_fused."""
    tm, reqs, _ = setup
    tm.use_vision_fused_mlp = fused_mlp
    try:
        for ids, views, sizes in reqs:
            a = tm.encode_prompt(ids, views, sizes)
            idx, text_ids, _, _ = multimodal.build_gather_plan(
                tm.cfg, [ids], [[views[0].shape[0]]], [sizes])
            with torch.no_grad():
                b = multimodal.multimodal_embeds(
                    tm, torch.from_numpy(views[0]), text_ids, idx,
                    fused_mlp=fused_mlp)
            assert torch.equal(a, b)
    finally:
        tm.use_vision_fused_mlp = None


def test_generate_matches_generate_fused(setup):
    """LaViDa.generate (encode_prompt + diffusion.generate) and
    generate_fused give the same tokens where both apply: one request, the
    same vision MLP path, with and without a prefix bucket and kv8."""
    tm, reqs, _ = setup
    gen = GenerationConfig(**GEN)
    ids, views, sizes = reqs[1]
    tm.use_vision_fused_mlp = False
    try:
        for bucket, kv8 in ((None, False), (128, False), (128, True)):
            a = tm.generate(ids, views, sizes, gen, prefix_bucket=bucket,
                            kv8=kv8)
            b = tm.generate_fused(ids, views, sizes, gen,
                                  prefix_bucket=bucket, kv8=kv8)
            np.testing.assert_array_equal(a, b)
    finally:
        tm.use_vision_fused_mlp = None


def test_generate_rejects_unported_branches(setup):
    """The branches of generate that were refused before they were ported
    (verbose, dLLM, draft tokens, no cache) now run on the batched int4
    layout; what the JAX package refuses still raises: kv8 or the mixed
    split with dLLM or verbose, and the mixed split without the cache
    (tests/test_torch_generate_branches.py holds the messages to JAX's)."""
    from lavida_mod_tpu_torch.generation import diffusion as td

    tm, _, _ = setup
    prefix = torch.zeros(1, 8, 512, dtype=torch.bfloat16)
    gen = GenerationConfig(**GEN)
    mask = tm.cfg.llada.mask_token_id
    x, history = td.generate(tm.llada, prefix, gen, verbose=True)
    assert len(history) == 16 and (x != mask).all()
    for kw in (dict(dllm_cache=8),
               dict(draft_tokens=np.full((1, 4), 7, np.int64))):
        assert (td.generate(tm.llada, prefix, gen, **kw) != mask).all()
    assert (td.generate(tm.llada, prefix,
                        gen.replace(prefix_lm=False)) != mask).all()
    for kw, g in ((dict(dllm_cache=8, kv8=True), gen),
                  (dict(verbose=True, act_int8_prefill=True), gen),
                  (dict(act_int8_prefill=True),
                   gen.replace(prefix_lm=False))):
        with pytest.raises(NotImplementedError):
            td.generate(tm.llada, prefix, g, **kw)
    assert as_port_config(gen) is gen
