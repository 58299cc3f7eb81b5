"""Port ops (lavida_mod_tpu_torch.ops) against the JAX package's ops on the
CPU: the same numpy inputs through both, in f32.

Tolerances: 1e-6 where both sides run the same elementwise math, 1e-5
where a matmul or a transcendental (sin/cos/exp) may round differently in
XLA and PyTorch; token ids and schedule tables exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lavida_mod_tpu.config import GenerationConfig
from lavida_mod_tpu.generation import diffusion as jdiff
from lavida_mod_tpu.ops import attention as jattn
from lavida_mod_tpu.ops import norms as jnorms
from lavida_mod_tpu.ops import pooling as jpool
from lavida_mod_tpu.ops import rope as jrope
from lavida_mod_tpu.ops import sampling as jsamp
from lavida_mod_tpu.ops import schedules as jsched
from lavida_mod_tpu_torch.generation import diffusion as tdiff
from lavida_mod_tpu_torch.ops import attention as tattn
from lavida_mod_tpu_torch.ops import norms as tnorms
from lavida_mod_tpu_torch.ops import pooling as tpool
from lavida_mod_tpu_torch.ops import rope as trope
from lavida_mod_tpu_torch.ops import sampling as tsamp
from lavida_mod_tpu_torch.ops import schedules as tsched

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm(with_weight):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 32), _rand(rng, 32)
    w_t = torch.from_numpy(w) if with_weight else None
    w_j = jnp.asarray(w) if with_weight else None
    _close(tnorms.rms_norm(torch.from_numpy(x), w_t, 1e-5),
           jnorms.rms_norm(jnp.asarray(x), w_j, 1e-5), atol=1e-6)


def test_layer_norm():
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 3, 7, 48), _rand(rng, 48), _rand(rng, 48)
    _close(tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), 1e-6),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             1e-6), atol=1e-5)


def test_rope_tables():
    s_t, c_t = trope.rope_tables(16, 512, 10000.0, torch.device("cpu"))
    s_j, c_j = jrope.rope_tables(16, 512, 10000.0)
    _close(s_t, s_j, atol=1e-5)
    _close(c_t, c_j, atol=1e-5)


@pytest.mark.parametrize("full_precision", [True, False])
def test_apply_rope(full_precision):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 6, 4, 16)
    pos = np.arange(40, 46)
    s_j, c_j = jrope.rope_tables(16, 64, 10000.0)
    s_t, c_t = torch.tensor(np.asarray(s_j)), torch.tensor(np.asarray(c_j))
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            s_t, c_t, full_precision),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), s_j, c_j,
                            full_precision), atol=1e-6)


@pytest.mark.parametrize("B,T,S,Hq,Hkv,masked", [
    (1, 8, 8, 4, 4, False),
    (2, 5, 13, 4, 2, True),     # GQA over a longer, padded cache
    (1, 32, 40, 8, 1, True),    # MQA
])
def test_dense_attention_with_bias(B, T, S, Hq, Hkv, masked):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, B, T, Hq, 16), _rand(rng, B, S, Hkv, 16), \
        _rand(rng, B, S, Hkv, 16)
    bias_t = bias_j = None
    if masked:
        valid = rng.integers(0, 2, (B, S)).astype(bool)
        valid[:, 0] = True
        bias_t = tattn.make_bias(kv_valid=torch.from_numpy(valid))
        bias_j = jattn.make_bias(kv_valid=jnp.asarray(valid))
        _close(bias_t, bias_j, atol=0)
    out_t = tattn.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), bias=bias_t)
    out_j = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), bias=bias_j)
    _close(out_t, out_j, atol=1e-5)


def test_make_bias_prefix_lm():
    rng = np.random.default_rng(4)
    valid = rng.integers(0, 2, (2, 12)).astype(bool)
    plen, qpos, kpos = np.array([3, 7]), np.arange(4, 12), np.arange(12)
    bt = tattn.make_bias(torch.from_numpy(valid), torch.from_numpy(plen),
                         torch.from_numpy(qpos), torch.from_numpy(kpos))
    bj = jattn.make_bias(jnp.asarray(valid), jnp.asarray(plen),
                         jnp.asarray(qpos), jnp.asarray(kpos))
    _close(bt, bj, atol=0)
    assert tattn.make_bias() is None


@pytest.mark.parametrize("mode,g,stride", [
    ("bilinear", 27, 2),        # so400m: 27x27 -> 14x14
    ("bilinear", 4, 2),         # tiny tower grid
    ("bilinear", 5, 2),
    ("average", 27, 2),
    ("max", 5, 2),
])
def test_pool_2d(mode, g, stride):
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, g * g, 8)
    _close(tpool.pool_2d(torch.from_numpy(x), mode, stride),
           jpool.pool_2d(jnp.asarray(x), mode, stride), atol=1e-5)


def _commit_inputs(rng, B=2, T=12, V=50, tie=False):
    x = np.where(rng.random((B, T)) < 0.7, 49, rng.integers(0, 40, (B, T)))
    logits = _rand(rng, B, T, V) * 3
    if tie:
        # identical rows -> identical confidences: the stable rank must
        # pick the lower positions first, as jnp.argsort does
        logits[:, 1:] = logits[:, :1]
        x[:] = 49
    k = np.array([3, 5])[:B]
    return x, logits, x == 49, k


@pytest.mark.parametrize("remasking", ["low_confidence", "margin",
                                       "entrophy"])
@pytest.mark.parametrize("tie", [False, True])
def test_denoise_commit_token_exact(remasking, tie):
    rng = np.random.default_rng(6)
    x, logits, mask, k = _commit_inputs(rng, tie=tie)
    for block_end in (12, 7):
        out_t = tsamp.denoise_commit(
            torch.from_numpy(x), torch.from_numpy(logits),
            torch.from_numpy(mask), torch.from_numpy(k),
            torch.tensor(block_end), remasking=remasking)
        out_j = jsamp.denoise_commit(
            jnp.asarray(x), jnp.asarray(logits), jnp.asarray(mask),
            jnp.asarray(k), block_end, remasking=remasking)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_topk_transfer_mask_ties_break_by_position():
    conf = torch.tensor([[0.5, 0.9, 0.5, 0.5, 0.9]])
    got = tsamp.topk_transfer_mask(conf, torch.tensor([3]))
    assert got.tolist() == [[True, True, False, False, True]]
    ref = jsamp.topk_transfer_mask(jnp.asarray(conf.numpy()),
                                   jnp.asarray([3]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampled_commit_needs_generator():
    rng = np.random.default_rng(7)
    x, logits, mask, k = _commit_inputs(rng)
    args = (torch.from_numpy(x), torch.from_numpy(logits),
            torch.from_numpy(mask), torch.from_numpy(k), 12)
    with pytest.raises(ValueError):
        tsamp.denoise_commit(*args, temperature=1.0)
    a = tsamp.denoise_commit(*args, temperature=1.0, remasking="random",
                             generator=torch.Generator().manual_seed(0))
    b = tsamp.denoise_commit(*args, temperature=1.0, remasking="random",
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    # at most k masked positions per row change
    assert ((a != torch.from_numpy(x)).sum(1) <= torch.from_numpy(k)).all()


@pytest.mark.parametrize("counts,steps,schedule", [
    ([32], 16, None),
    ([32, 30], 16, None),
    ([31], 7, None),
    ([32], 16, "shift"),
    ([32], 16, "cosine"),
    ([32], 16, "logit_normal"),
    ([32], 16, "linear"),
    ([20, 3], 8, "shift"),
])
def test_schedules_match(counts, steps, schedule):
    np.testing.assert_array_equal(
        tsched.num_transfer_tokens_scheduled(np.array(counts), steps,
                                             schedule, shift=0.33),
        jsched.num_transfer_tokens_scheduled(np.array(counts), steps,
                                             schedule, shift=0.33))


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=32, block_length=32, step_per_block=16),
    dict(max_new_tokens=64, block_length=16, steps=32),
    dict(max_new_tokens=32, block_length=8, steps=None, step_ratio=0.5),
    dict(max_new_tokens=16, block_length=8, schedule="shift",
         schedule_shift=0.33),
    dict(max_new_tokens=32, block_length=16, schedule="cosine", steps=8),
])
def test_control_table_matches(kw):
    gen = GenerationConfig(**kw)
    G, mask_id = gen.max_new_tokens, 7
    rng = np.random.default_rng(8)
    plain = np.full((2, G), mask_id)
    drafted = plain.copy()
    drafted[:, :gen.block_length] = 3           # a fully drafted block
    drafted[1, rng.integers(0, G, G // 3)] = 4  # scattered drafts in row 1
    for x0 in (plain, drafted):
        kt, be = tdiff.build_control_table(x0, 0, G, gen, mask_id)
        kj, bj = jdiff.build_control_table(x0, 0, G, gen, mask_id)
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(be, bj)
        assert kt.dtype == kj.dtype and be.dtype == bj.dtype


def test_resolve_steps_matches():
    for args in [(32, 32, None, 16, None), (64, 16, 32, None, None),
                 (32, 8, None, None, 0.5), (128, 128, 64, None, None)]:
        assert tsched.resolve_steps(*args) == jsched.resolve_steps(*args)
