"""The port's serving slice as a whole against the JAX package on the CPU:
`LaViDa.generate_fused` of lavida_mod_tpu_torch against the JAX
`LaViDa.generate_fused(use_flash_prefill=True)` (whose prefill attention
runs the Pallas short-attention kernel in interpret mode off-TPU), with the
weights of one JAX `LaViDa.random_init` carried over by convert.py.

Tokens must be EXACT at temperature 0 with low_confidence remasking, for
two images with different view counts, with and without prefix_bucket.
The LLaDA blocks are unstacked, so the JAX side takes the same
preallocated-cache branch (diffusion.py:139) the port implements, and its
weights are scaled x10 from the init so the tiny model's tokens vary (at
std 0.02 every position decodes the same token, which would prove little).

Also: the port package imports without jax, and its predict CLI runs.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (GenerationConfig, LaViDaConfig,
                                   VisionConfig, tiny_llada_config,
                                   tiny_siglip_config)
from lavida_mod_tpu.data.anyres import anyres_grid_shape
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.models.lavida import LaViDa

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))


@pytest.fixture(scope="module")
def models():
    jm = JLaViDa.random_init(CFG, 0, jnp.float32)
    jm.params["llada"] = jl.unstack_blocks(jax.tree.map(
        lambda a: a * 10.0 if a.ndim >= 2 else a, jm.params["llada"]))
    tm = LaViDa.from_jax(CFG, jax.tree.map(np.asarray, jm.params), "cpu")
    return jm, tm


def _request(size, seed, n_text=6):
    nw, nh = anyres_grid_shape(size, CFG.vision.grid_pinpoints, 56)
    rng = np.random.default_rng(seed)
    views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(np.float32)
    text = rng.integers(3, 400, size=n_text)
    return np.concatenate([text[:2], [-200], text[2:]]), views


@pytest.mark.parametrize("size,n_views", [((100, 60), 5), ((120, 40), 3)])
@pytest.mark.parametrize("prefix_bucket", [None, 64])
def test_generate_fused_token_exact(models, size, n_views, prefix_bucket):
    jm, tm = models
    ids, views = _request(size, seed=n_views)
    assert views.shape[0] == n_views
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           prefix_lm=True, remasking="low_confidence")
    ref = jm.generate_fused(ids, [views], [size], gen,
                            prefix_bucket=prefix_bucket,
                            use_flash_prefill=True)
    got = tm.generate_fused(ids, [views], [size], gen,
                            prefix_bucket=prefix_bucket)
    np.testing.assert_array_equal(got, ref)
    assert len(set(ref.tolist())) >= 4, "degenerate reference tokens"
    assert (got != CFG.llada.mask_token_id).all()


def test_generate_fused_schedule_and_steps(models):
    """A shift schedule with 2 blocks of 4 steps (a shorter control table
    than the gen length) is token-exact too."""
    jm, tm = models
    ids, views = _request((100, 60), seed=9, n_text=11)
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           step_per_block=4, schedule="shift",
                           schedule_shift=0.33)
    np.testing.assert_array_equal(
        tm.generate_fused(ids, [views], [(100, 60)], gen),
        jm.generate_fused(ids, [views], [(100, 60)], gen,
                          use_flash_prefill=True))


def test_generate_fused_text_only(models):
    jm, tm = models
    ids = np.arange(3, 40)
    gen = GenerationConfig(max_new_tokens=8, block_length=8)
    np.testing.assert_array_equal(
        tm.generate_fused(ids, gen=gen),
        jm.generate_fused(ids, gen=gen, use_flash_prefill=True))


def test_generate_fused_sampled_is_seeded(models):
    _, tm = models
    ids, views = _request((100, 60), seed=5)
    gen = GenerationConfig(max_new_tokens=8, block_length=8,
                           temperature=1.0, remasking="random")

    def run(seed):
        return tm.generate_fused(ids, [views], [(100, 60)], gen,
                                 generator=torch.Generator().manual_seed(seed))

    np.testing.assert_array_equal(run(3), run(3))
    assert (run(3) != CFG.llada.mask_token_id).all()


def _jax_free_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


JAX_FREE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None       # any import of jax now fails
import lavida_mod_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "lavida_mod_tpu.ops" not in sys.modules, "imported the JAX ops"
print(len(names))
"""


def test_package_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", JAX_FREE], cwd=REPO,
                         env=_jax_free_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_predict_cli_runs_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "from lavida_mod_tpu_torch.predict import main; "
            "main(['--tiny', '--device', 'cpu', '--max-new-tokens', '8', "
            "'--step-per-block', '4'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_jax_free_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[predict] output ids:" in out.stdout
    assert "[predict] latency:" in out.stdout
