"""Sharding (lavida_mod_tpu_torch.parallel) on the CPU: the mesh and the
rule table against the JAX package's, and the sharded model run as
processes over gloo (tests/torch_parallel_worker.py), each case a world of
its own with its own timeout:

  - `make_mesh` raises JAX's AssertionErrors; `maybe_init_distributed` is
    a no-op at world size 1 and raises on a failed bring-up;
  - `param_specs` equals JAX's `param_specs` leaf by leaf through the
    converter's name map, for the tiny LLaDA, the composed LaViDa and a
    LoRA tree (tests/test_train.py:124-152);
  - generation at JAX's meshes (tests/test_sharded_inference.py), in f32,
    temperature 0, low-confidence remasking: `generate` at fsdp 4 x tp 2,
    the full-context (no cache) `generate` at dp 2 x fsdp 2 x tp 2,
    `generate_chunked_prefill` (B = 5, chunk 2) at fsdp 2 x tp 4, the
    batched path (B = 4) at tp 8, and `LaViDa.shard(tp=2, fsdp=2, dp=2)`
    multimodal: tokens equal to the unsharded port's, and a teacher-forced
    forward's logits within 1e-6 of their magnitude (were a near-tie to
    flip, the tokens would be compared teacher-forced and the flips
    counted; none flips at these seeds); the tower's fused MLP under tp
    takes the whole fc1 / fc2 weights, equal to the unsharded tower's;
  - the multimodal training step at dp 2 x fsdp 2 x tp 2 (tests/
    test_train.py:90-121): the first step's loss and grad_norm within 1e-6
    and every gradient within 1e-5 of the unsharded step's; 5 steps with
    finite losses and norms, the loss falling;
  - the training CLI at --dp 2 --fsdp 2 --tp 2: 4 steps, saves, a resume
    bit-equal to the saved state; a one-process checkpoint resumed by the
    sharded run and a sharded checkpoint resumed by one process, bit-equal;
  - predict --tp 2 prints the unsharded answer; rank 0 owns the requests
    and the other ranks replay its model calls; the serving entry points
    refuse --tp with a quantized layout or KV cache in JAX's words;
  - a one-rank mesh gives the unsharded step's loss and grad_norm and the
    unsharded request's tokens bit for bit (chip_smoke's check on the
    card);
  - the evaluator shares documents over a mesh's dp groups only inside
    `dp_groups`.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from torch_parallel_worker import REPO, free_port, launch

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,fsdp,tp,n", [
    (3, None, 1, 8), (2, 3, 1, 8), (1, 1, 3, 8), (2, 2, 2, 4)])
def test_make_mesh_raises_jaxs_assertions(dp, fsdp, tp, n):
    from lavida_mod_tpu.parallel import make_mesh as jmake_mesh
    from lavida_mod_tpu_torch.parallel import make_mesh

    with pytest.raises(AssertionError) as want:
        jmake_mesh(dp=dp, fsdp=fsdp, tp=tp, devices=jax.devices()[:n])
    with pytest.raises(AssertionError) as got:
        make_mesh(dp=dp, fsdp=fsdp, tp=tp, devices=range(n))
    assert got.value.args == want.value.args


def test_maybe_init_distributed_is_a_noop_alone_and_raises(monkeypatch):
    import torch.distributed as dist

    from lavida_mod_tpu_torch.parallel import maybe_init_distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert maybe_init_distributed("cpu") is False
    assert not dist.is_initialized()
    # a world of 2 with no rendezvous address: the bring-up fails loudly
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError):
        maybe_init_distributed("cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the rule table against JAX's
# ---------------------------------------------------------------------------

def _jax_tree(kind):
    from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                       tiny_llada_config, tiny_siglip_config)
    from lavida_mod_tpu.models import llada as jl
    from lavida_mod_tpu.models import multimodal as jmm

    if kind == "llada":
        return {"llada": jl.init_params(tiny_llada_config(),
                                        jax.random.PRNGKey(0))}
    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32))
    params = jmm.init_params(cfg, jax.random.PRNGKey(0))
    if kind == "lora":
        from lavida_mod_tpu.train.lora import add_lora

        params = add_lora(params, jax.random.PRNGKey(1), rank=4)
    return params


def _path(p) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


@pytest.mark.parametrize("kind", ["llada", "lavida", "lora"])
def test_param_specs_equal_jaxs_leaf_by_leaf(kind):
    """Each JAX leaf is filled with its own index, taken through
    convert.state_dict_from_jax to the port's names, and its JAX spec --
    over [L, in, out] for a stacked kernel, so without the layer dim and
    reversed for the port's [out, in] -- must be the port's spec."""
    from lavida_mod_tpu.parallel import batch_spec as jbatch_spec
    from lavida_mod_tpu.parallel import param_specs as jparam_specs
    from lavida_mod_tpu_torch.convert import state_dict_from_jax
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.llada import LLaDA
    from lavida_mod_tpu_torch.parallel import batch_spec, param_specs
    from lavida_mod_tpu_torch.parallel.sharding import spec_axes

    params = _jax_tree(kind)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    jspecs = dict(zip((_path(p) for p, _ in leaves),
                      jax.tree_util.tree_leaves(
                          jparam_specs(params),
                          is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))))
    paths = [_path(p) for p, _ in leaves]
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(a), i, np.float32)
         for i, (_, a) in enumerate(leaves)])
    state = state_dict_from_jax(ids)
    if kind == "llada":
        from lavida_mod_tpu_torch.config import tiny_llada_config

        model = LLaDA(tiny_llada_config(), "meta")
        state = {k[len("llada."):]: v for k, v in state.items()}
    else:
        from lavida_mod_tpu_torch.predict import tiny_config

        model = LaViDa.from_jax(tiny_config(),
                                jax.tree.map(np.asarray, ids), "cpu")
    specs = param_specs(model)
    assert set(specs) == {k for k in state if not k.endswith("__trim__")}
    checked = 0
    for name, t in state.items():
        path = paths[int(t.reshape(-1)[0])]
        jspec = list(jspecs[path]) + [None] * (np.ndim(
            np.asarray(jax.tree_util.tree_leaves(params)[
                paths.index(path)])) - len(jspecs[path]))
        stacked = re.search(r"(^|/)(blocks|siglip/layers)/", path)
        if stacked:
            jspec = jspec[1:]
        if path.endswith("kernel"):
            jspec = jspec[::-1]
        while jspec and jspec[-1] is None:
            jspec.pop()
        assert spec_axes(specs[name], t.dim()) == tuple(jspec), (name, path)
        checked += 1
    assert checked == len(specs)
    sharded = [n for n, s in specs.items() if any(p.is_shard() for p in s)]
    assert sharded and all(not n.endswith(("lora_a", "lora_b", "bias"))
                           for n in sharded)
    assert tuple(p.is_shard() for p in batch_spec()) == (True, True, False)
    assert jbatch_spec() == jax.sharding.PartitionSpec(("dp", "fsdp"))


# ---------------------------------------------------------------------------
# sharded runs over gloo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["generate_fsdp4_tp2",
                                  "generate_full_dp2_fsdp2_tp2",
                                  "chunked_fsdp2_tp4", "batched_tp8"])
def test_sharded_generation_is_token_equal(case, tmp_path):
    r = launch(case, 8, tmp_path, timeout=90)
    flips = int((r["out"] != r["ref"]).sum())
    assert flips == 0, (flips, r["ref"], r["out"])
    scale = np.abs(r["logits_ref"]).max()
    assert np.abs(r["logits"] - r["logits_ref"]).max() <= 1e-6 * scale
    # tp 2 splits the 2 KV heads; tp 4 / 8 gather them (GQA)
    assert int(r["kv_heads"]) == (1 if case.endswith("tp2") else 2)


def test_lavida_shard_multimodal_is_token_equal(tmp_path):
    r = launch("lavida_shard_dp2_fsdp2_tp2", 8, tmp_path, timeout=90)
    np.testing.assert_array_equal(r["out"], r["ref"])
    np.testing.assert_allclose(r["prefix"], r["prefix_ref"], rtol=0,
                               atol=1e-6 * np.abs(r["prefix_ref"]).max())
    # the fused ViT MLP under tp takes the whole fc1 / fc2 weights
    np.testing.assert_allclose(r["fused"], r["fused_ref"], rtol=0,
                               atol=1e-6 * np.abs(r["fused_ref"]).max())
    assert int(r["n_sharded"]) > 0
    assert r["fused_ok"].tolist() == [True, True, True]


def test_sharded_train_step_matches_the_unsharded(tmp_path):
    r = launch("train_dp2_fsdp2_tp2", 8, tmp_path, timeout=120)
    assert r["losses"][0] == pytest.approx(float(r["ref_loss"]), rel=1e-6)
    assert r["norms"][0] == pytest.approx(float(r["ref_norm"]), rel=1e-6)
    assert r["num_sup"][0] == r["num_sup"][1]
    assert np.isfinite(r["losses"]).all() and np.isfinite(r["norms"]).all()
    assert r["losses"][-1] < r["losses"][0], r["losses"]
    names = [k[len("grad/"):] for k in r if k.startswith("grad/")]
    assert len(names) == 61 and int(r["n_dtensor"]) > 0
    for n in names:
        g, want = r["grad/" + n], r["ref/" + n]
        if n.startswith("siglip.") and n.endswith("k_proj.bias"):
            # zero in exact arithmetic (a shift shared by all keys)
            assert np.abs(g).max() < 1e-6 and np.abs(want).max() < 1e-6
            continue
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), n


def test_sharded_cli_saves_and_resumes_bit_equal(tmp_path):
    """--dp 2 --fsdp 2 --tp 2 over 8 processes: 4 steps, a second run
    restores checkpoint-4 bit-equal; a one-process run's checkpoint-2 is
    resumed by the sharded CLI bit-equal, and the sharded checkpoint-4 by
    one process bit-equal."""
    from lavida_mod_tpu_torch.tools.make_synthetic_data import make
    from lavida_mod_tpu_torch.train import cli
    from lavida_mod_tpu_torch.utils.checkpoint import restore_checkpoint

    make(str(tmp_path / "syn"), n=8, size=96)
    base = ["--tiny", "--device", "cpu", "--data-path",
            str(tmp_path / "syn/data.json"), "--image-folder",
            str(tmp_path / "syn/images"), "--batch-size", "4", "--lr",
            "1e-3", "--save-every", "2", "--log-every", "1", "--prefetch",
            "0"]
    one = cli.main(base + ["--output-dir", str(tmp_path / "unsharded"),
                           "--steps", "2"])
    r = launch("cli_dp2_fsdp2_tp2", 8, tmp_path, timeout=150)
    assert r["restored"].tolist() == [4, 4, 2, 2]
    assert int(r["mismatch"]) == 0, str(r["first_bad"])
    assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 4
    assert r["losses"][:2] == pytest.approx(one["losses"], rel=1e-2)
    rows = [json.loads(l) for l in open(tmp_path / "sharded/metrics.jsonl")]
    assert [row["step"] for row in rows] == [1, 2, 3, 4]
    back = cli.main(base + ["--output-dir", str(tmp_path / "sharded"),
                            "--steps", "4"])
    assert back["start_step"] == 4
    want = restore_checkpoint(str(tmp_path / "sharded/checkpoint-4"))
    params, opt = cli.train_payload(back["state"])
    for n, t in params["model"].items():
        assert torch.equal(t, want["params"]["model"][n]), n
    for n, t in params["masters"].items():
        assert torch.equal(t, want["params"]["masters"][n]), n
    for g, st in opt["groups"].items():
        for n, t in st["mu"].items():
            assert torch.equal(t, want["opt_state"]["groups"][g]["mu"][n])


def test_predict_tp2_prints_the_unsharded_answer(tmp_path):
    argv = ["--tiny", "--device", "cpu", "--max-new-tokens", "16"]
    one = subprocess.run(
        [sys.executable, "-m", "lavida_mod_tpu_torch.predict", *argv],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert one.returncode == 0, one.stderr[-2000:]
    r = launch(None, 2, tmp_path / "tp", timeout=120,
               argv=[*argv, "--tp", "2"],
               module="lavida_mod_tpu_torch.predict")
    ids = [l for l in one.stdout.splitlines() if "output ids" in l]
    got = [l for l in r["stdout"][0].splitlines() if "output ids" in l]
    assert ids and got == ids
    assert "layout: bfloat16, tp 2" in r["stdout"][0]
    assert r["stdout"][1] == ""          # rank 1 prints nothing


def test_rank_zero_owns_the_requests(tmp_path):
    """The serving flow of the --tp entry points (parallel/lockstep.py):
    rank 0's line reaches every rank; each model call rank 0 makes is
    replayed by the other rank, in order, the two meeting in the call's
    collectives."""
    r = launch("lockstep", 2, tmp_path, timeout=60)
    assert str(r["line"]) == "hello" and int(r["n"]) == 3
    assert bool(r["same"]) and r["sums"].tolist() == [4.0, 12.0, 2.0]


@pytest.mark.parametrize("argv,words", [
    (["--mixed"], "--tp is bf16 serving (quantized layouts have custom "
                  "leaf structures the sharding rules don't cover); drop "
                  "--int4/--mixed"),
    (["--int4"], "drop --int4/--mixed"),
    (["--kv8"], "--tp is bf16 serving; drop --kv8/--kv4 (tp>=2 has the "
                "HBM headroom kv8 buys)"),
    (["--kv4"], "drop --kv8/--kv4")])
def test_predict_refuses_tp_as_jax(argv, words):
    from lavida_mod_tpu_torch import predict

    with pytest.raises(SystemExit, match=re.escape(words)):
        predict.main(["--tiny", "--device", "cpu", "--tp", "2", *argv])


def test_serving_entry_points_refuse_tp_as_jax(tmp_path):
    """The worker, the chat and the eval CLI: JAX's bf16-only refusals,
    before the checkpoint is read (each file tests its own too)."""
    from lavida_mod_tpu_torch.eval.__main__ import main as eval_main
    from lavida_mod_tpu_torch.serve import cli as chat
    from lavida_mod_tpu_torch.serve import worker

    ckpt = str(tmp_path / "none")
    with pytest.raises(SystemExit, match="drop --int4/--mixed"):
        worker.build_eval_model(worker.parse_args(
            ["--model-path", ckpt, "--tp", "2", "--mixed", "--device",
             "cpu"]))
    with pytest.raises(SystemExit, match="use --quant none"):
        chat.main(["--model-path", ckpt, "--tp", "2", "--quant", "int4",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="drop --kv8"):
        eval_main(["--model-path", ckpt, "--tp", "2", "--quant", "none",
                   "--kv8", "--device", "cpu", "--tasks", "pope"])


@pytest.fixture()
def one_rank():
    """A one-process gloo group (the card's one-rank NCCL mesh, on the
    CPU)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_is_the_unsharded_model_bit_for_bit(one_rank):
    """On a one-rank mesh every collective is the identity and each
    sharded op is the unsharded one in its order: a stage-1 step (frozen
    LLaDA and tower as DTensors, their gradients taken by the hooks) gives
    the unsharded step's loss and grad_norm bit for bit, and a request the
    same tokens -- what chip_smoke checks on the card with the kernels."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.parallel import make_mesh
    from lavida_mod_tpu_torch.parallel.sharding import is_dtensor
    from lavida_mod_tpu_torch.predict import tiny_config
    from lavida_mod_tpu_torch.train import step as tstep
    from torch_parallel_worker import _train_batch

    cfg = tiny_config()
    batch = _train_batch(cfg)
    metrics = []
    for sharded in (False, True):
        model = LaViDa.random_init(cfg, 0, torch.float32, "cpu")
        mesh = None
        if sharded:
            mesh = make_mesh(1, 1, 1)
            model.shard(mesh=mesh)
            assert sum(is_dtensor(p) for p in model.parameters()) == 28
        opt = tstep.make_freeze_optimizer("mm_mlp_adapter", lr=1e-3,
                                          warmup_steps=0, total_steps=10)
        state = tstep.init_train_state(model, opt, torch.bfloat16)
        step = tstep.make_multimodal_train_step(cfg, opt, remat=True,
                                                mesh=mesh)
        metrics.append(step(state, batch,
                            torch.Generator().manual_seed(3)))
    for k in ("loss", "grad_norm", "acc_mask", "num_supervised"):
        assert torch.equal(metrics[0][k], metrics[1][k]), k

    rng = np.random.default_rng(0)
    ids = rng.integers(3, 400, size=12).astype(np.int64)
    ids[4] = -200
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=8, block_length=8)
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu")
    ref = model.generate_fused(ids, [views], [(100, 80)], gen)
    model.shard(mesh=make_mesh(1, 1, 1))
    out = model.generate_fused(ids, [views], [(100, 80)], gen)
    np.testing.assert_array_equal(out, ref)


def test_eval_dp_groups_is_scoped_to_its_block():
    """Inside `dp_groups(mesh)` documents go out over the mesh's dp
    coordinate (here rank 1 of dp 2, fsdp 3); outside, over the default
    group's ranks again (one process: every document)."""
    from lavida_mod_tpu_torch.eval import evaluator as ev

    class Mesh:
        mesh_dim_names = ("dp", "fsdp", "tp")

        def get_coordinate(self):
            return [1, 2, 0]

        def size(self, i):
            return (2, 3, 1)[i]

    docs = [{"id": i} for i in range(7)]
    assert ev.rank_and_world() == (0, 1)
    with ev.dp_groups(Mesh()):
        assert ev.rank_and_world() == (1, 2)
        assert ev.shard_docs(docs) == docs[1::2]
    assert ev.rank_and_world() == (0, 1)
    assert ev.shard_docs(docs) is docs
    with pytest.raises(RuntimeError):
        with ev.dp_groups(Mesh()):
            raise RuntimeError("a failed eval")
    assert ev.rank_and_world() == (0, 1)
