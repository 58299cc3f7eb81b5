"""The port's training CLI (`python -m lavida_mod_tpu_torch.train`) and its
checkpoints (lavida_mod_tpu_torch.utils.checkpoint) on the CPU, against the
repository's train.py and the JAX package's utils:

  - the flags are train.py's, plus --device;
  - `make_batch` gives the batches JAX's train.py builds from its own
    dataset, collator and gather plan (train.py:319-357) for the same seed
    and data, bit for bit, for three steps, without prefetch and through
    one producer thread;
  - a tiny run logs train.py's metrics and saves; a second run into the
    same directory resumes from the newest checkpoint with the state bit
    for bit and JAX's resume rules (the batch stream restarts from the
    seed, the mask generator is seeded from the absolute microstep);
  - checkpoints: sync and async saves restore bit-equal, successive async
    saves commit in order and the newest wins, a killed temporary
    directory is never a resume point, the adapter-only layout and its
    resume failure are JAX's;
  - a mesh the process group cannot hold exits naming torchrun (the
    sharded CLI: tests/test_torch_parallel.py; --eval-tasks runs the
    in-training eval: tests/test_torch_eval_hook.py).
The card case (`-k cuda`) runs the tiny CLI on the card with a resume.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.train import cli
from lavida_mod_tpu_torch.tools.make_synthetic_data import make
from lavida_mod_tpu_torch.utils import checkpoint as ck

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("syn")
    path = make(str(d), n=8, size=96)
    return path, str(d / "images")


def _argv(data, out, *extra):
    path, images = data
    return ["--tiny", "--device", "cpu", "--data-path", path,
            "--image-folder", images, "--output-dir", str(out),
            "--batch-size", "2", "--lr", "1e-3", *extra]


def test_flags_are_train_pys():
    src = (REPO / "train.py").read_text()
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', src))
    port = {a for act in cli.build_parser()._actions
            for a in act.option_strings if a.startswith("--")}
    assert jax_flags <= port
    assert port - jax_flags == {"--device", "--help"}


def _jax_batches(data, seed, steps):
    """train.py:319-357's make_batch on JAX's own functions."""
    import jax.numpy as jnp

    from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                       tiny_llada_config, tiny_siglip_config)
    from lavida_mod_tpu.data.dataset import SupervisedDataset, collate_batch
    from lavida_mod_tpu.models import multimodal as mm

    cfg = LaViDaConfig(llada=tiny_llada_config(), vision=VisionConfig(
        siglip=tiny_siglip_config(), mm_hidden_size=32,
        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
    ds = SupervisedDataset(data[0], cli.ByteTokenizer(), cfg.vision,
                           image_folder=data[1], seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.choice(len(ds), size=3, replace=False)
        items = ds.get_batch(idx)
        b = collate_batch(items, pad_token_id=cfg.llada.pad_token_id,
                          eos_token_id=cfg.llada.eos_token_id,
                          model_max_length=cfg.tokenizer_model_max_length,
                          rng=rng)
        n_views = [[v.shape[0] for v in it["images"]] for it in items]
        pix = [v for it in items for v in it["images"]]
        ids = [r[m] for r, m in zip(b["input_ids"], b["attention_mask"])]
        labs = [r[m] for r, m in zip(b["labels"], b["attention_mask"])]
        gi, ti, _, lab = mm.build_gather_plan(cfg, ids, n_views,
                                              b["image_sizes"], labs)
        T = cli.pad_to_bucket(gi.shape[1], 32)
        if T > gi.shape[1]:
            gi, ti, _, lab = mm.build_gather_plan(
                cfg, ids, n_views, b["image_sizes"], labs, pad_to=T)
        pv = np.concatenate(pix, axis=0)
        NV = cli.pad_to_bucket(pv.shape[0], 4)
        pv = np.concatenate([pv, np.zeros((NV - pv.shape[0],)
                                          + pv.shape[1:], pv.dtype)])
        out.append({"pixel_values": np.asarray(
            jnp.asarray(pv, jnp.bfloat16).astype(jnp.float32)),
            "text_ids": np.asarray(jnp.asarray(ti)),
            "gather_idx": np.asarray(jnp.asarray(gi)),
            "labels": np.asarray(jnp.asarray(lab))})
    return out


@pytest.mark.parametrize("producers", [0, 1])
def test_make_batch_matches_jax(data, producers):
    from concurrent.futures import ThreadPoolExecutor

    from lavida_mod_tpu_torch.data.dataset import SupervisedDataset

    seed = 3
    want = _jax_batches(data, seed, 3)
    cfg = cli.geometry_config("tiny")
    ds = SupervisedDataset(data[0], cli.ByteTokenizer(), cfg.vision,
                           image_folder=data[1], seed=seed)
    rng = np.random.default_rng(seed)
    with ThreadPoolExecutor(max_workers=2) as pool:
        def produce(r):
            return cli.make_batch(ds, cfg, r, 3, 32, 4, pool=pool)

        if producers:
            pf = cli.Prefetcher(produce, [rng], depth=2)
            try:
                got = [pf.next() for _ in range(3)]
            finally:
                pf.close()
        else:
            got = [produce(rng) for _ in range(3)]
    for a, b in zip(want, got):
        assert b["pixel_values"].dtype == torch.bfloat16
        np.testing.assert_array_equal(b["pixel_values"].float().numpy(),
                                      a["pixel_values"])
        for k in ("text_ids", "gather_idx", "labels"):
            np.testing.assert_array_equal(np.asarray(b[k]), a[k])


def test_prefetch_hands_a_producer_error_to_the_consumer():
    def produce(rng):
        raise FileNotFoundError("no such image")

    pf = cli.Prefetcher(produce, [np.random.default_rng(0)], depth=2)
    try:
        with pytest.raises(FileNotFoundError, match="no such image"):
            pf.next()
    finally:
        pf.close()
    assert not any(t.is_alive() for t in pf._threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _snapshot(state):
    params, opt_state = cli.train_payload(state)
    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in _flat({"params": params,
                               "opt_state": opt_state}).items()}


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


JAX_LOG_KEYS = {"step", "time", "loss", "acc_mask", "num_supervised",
                "grad_norm", "steps_per_s", "tokens_per_s"}


@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_resume_restores_state_and_follows_jax_rules(data, tmp_path,
                                                     precision):
    """Run A: 2 optimizer steps of 2 microsteps, a save at each.  Run B
    into the same directory with the same --steps restores checkpoint-4
    and takes no step: its state is A's, bit for bit.  Run C with
    --steps 3 resumes at microstep 4: its first batch is the first of a
    fresh stream (JAX saves no rng) and its mask generator is seeded
    from microstep 4, so its first loss is the loss of that batch and
    generator on the restored state."""
    out = tmp_path / "run"
    common = ["--grad-accum", "2", "--log-every", "1", "--save-every", "1",
              "--precision", precision, "--prefetch", "0"]
    a = cli.main(_argv(data, out, "--steps", "2", *common))
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4",
                                       "metrics.jsonl"]
    rows = [json.loads(l) for l in open(out / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(set(r) == JAX_LOG_KEYS for r in rows)
    assert all(np.isfinite(r["loss"]) for r in rows)
    final = _snapshot(a["state"])
    b = cli.main(_argv(data, out, "--steps", "2", *common))
    assert b["restored_from"].endswith("checkpoint-4")
    assert b["start_step"] == 4 and b["losses"] == []
    _same_state(_snapshot(b["state"]), final)
    c = cli.main(_argv(data, out, "--steps", "3", *common))
    assert c["start_step"] == 4 and len(c["losses"]) == 2

    # the first resumed microstep by hand
    from lavida_mod_tpu_torch.data.dataset import SupervisedDataset
    from lavida_mod_tpu_torch.train import step as tstep

    state = b["state"]
    cfg = cli.geometry_config("tiny")
    ds = SupervisedDataset(data[0], cli.ByteTokenizer(), cfg.vision,
                           image_folder=data[1], seed=0)
    batch = cli.make_batch(ds, cfg, np.random.default_rng(0), 2)
    opt = tstep.make_freeze_optimizer(
        "mm_mlp_adapter,mm_vision_tower,mm_language_model", lr=1e-3,
        warmup_steps=0, total_steps=3, grad_accum=2,
        accum_dtype=torch.float32 if precision == "bf16" else None)
    step = tstep.make_multimodal_train_step(cfg, opt, remat="whole_layer",
                                            attention_impl="dense")
    gen = torch.Generator().manual_seed(0 * 131 + 4)
    m = step(state, batch, gen)
    assert m["loss"].item() == c["losses"][0]


def test_cli_module_runs_logs_and_saves(data, tmp_path):
    """`python -m lavida_mod_tpu_torch.train --tiny --device cpu` in a
    process of its own, with prefetch, a profile and adapter-only saves;
    a second run into the directory fails to restore as JAX's does."""
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "lavida_mod_tpu_torch.train",
           *_argv(data, out, "--steps", "4", "--log-every", "2",
                  "--save-every", "2", "--adapter-only-save",
                  "--tunable", "mm_mlp_adapter", "--profile",
                  str(tmp_path / "prof"))]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[train] step 4:" in proc.stdout
    rows = [json.loads(l) for l in open(out / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 4]
    assert all(set(r) == JAX_LOG_KEYS for r in rows)
    assert (tmp_path / "prof" / "trace.json").exists()
    for n in (2, 4):
        assert sorted(os.listdir(out / f"checkpoint-{n}")) == ["mm_projector"]
    assert ck.latest_checkpoint(str(out)).endswith("checkpoint-4")
    with pytest.raises(FileNotFoundError, match="No structure"):
        cli.main(_argv(data, out, "--steps", "5", "--prefetch", "0"))


@pytest.mark.parametrize("argv,item", [
    (["--dp", "2"], "torchrun"), (["--fsdp", "2"], "torchrun"),
    (["--tp", "2"], "torchrun")])
def test_refusals_name_their_item(data, tmp_path, capsys, argv, item):
    """A mesh of more ranks than the process group has (one process, no
    torchrun) exits naming the launcher; the sharded CLI itself runs in
    tests/test_torch_parallel.py."""
    with pytest.raises(SystemExit):
        cli.main(_argv(data, tmp_path, *argv))
    assert item in capsys.readouterr().err


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 64, generator=g) * scale,
            "b": (torch.randn(64, generator=g) * scale).bfloat16(),
            "inner": {"count": 3, "m": torch.arange(5)}, "empty": {}}


@pytest.mark.parametrize("async_save", [False, True])
def test_save_restore_roundtrip(tmp_path, async_save):
    params, opt = _tree(0), {"mu": _tree(1), "mini_step": 1}
    path = ck.save_checkpoint(str(tmp_path), 3, params, opt,
                              async_save=async_save)
    ck.wait_for_saves()
    got = ck.restore_checkpoint(path)
    assert got["step"] == 3
    _same_state(_flat(got), _flat({"params": params, "opt_state": opt,
                                   "step": 3}))
    tmpl = {"params": _tree(5), "opt_state": {"mu": _tree(6),
                                              "mini_step": 0}, "step": 0}
    _same_state(_flat(ck.restore_checkpoint(path, tmpl)), _flat(got))
    assert not any(n.endswith(".safetensors") or n.endswith(".bin")
                   for n in os.listdir(path))


def test_async_saves_commit_in_order_and_newest_wins(tmp_path):
    """Two async saves (the source changed after each) both land with the
    contents they were staged with; a second save of one step replaces
    the first; a dead temporary directory is never a resume point."""
    p1 = _tree(1)
    ck.save_checkpoint(str(tmp_path), 1, p1, async_save=True)
    p2 = {k: (v * 2 if isinstance(v, torch.Tensor) else v)
          for k, v in p1.items()}
    ck.save_checkpoint(str(tmp_path), 2, p2, async_save=True)
    p1["w"].zero_()
    ck.save_checkpoint(str(tmp_path), 2, _tree(9), async_save=True)
    ck.wait_for_saves()
    assert torch.equal(ck.restore_checkpoint(
        str(tmp_path / "checkpoint-1"))["params"]["w"],
        _tree(1)["w"])
    assert torch.equal(ck.restore_checkpoint(
        str(tmp_path / "checkpoint-2"))["params"]["w"], _tree(9)["w"])
    dead = tmp_path / "checkpoint-7.tmp-123-0"
    dead.mkdir()
    (dead / ck.TENSORS).write_bytes(b"\0" * 16)
    assert ck.latest_checkpoint(str(tmp_path)).endswith("checkpoint-2")
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-1", "checkpoint-2",
                                            "checkpoint-7.tmp-123-0"]


def test_adapter_only_layout_and_resume_match_jax(tmp_path):
    """The adapter lands at checkpoint-N/mm_projector in both packages,
    latest_checkpoint returns checkpoint-N in both, and a full restore of
    it raises FileNotFoundError in both (JAX's train.py:283 test never
    fires: ROADMAP.md Queue 3)."""
    import jax.numpy as jnp

    from lavida_mod_tpu import utils as ju

    jpar = {"projector": {"w": jnp.ones((2, 2))},
            "image_newline": jnp.zeros(2), "llada": {"x": jnp.ones(3)}}
    tpar = {"projector.0.weight": torch.ones(2, 2),
            "image_newline": torch.zeros(2), "llada.x": torch.ones(3)}
    jp = ju.save_adapter_only(str(tmp_path / "jax"), 2, jpar)
    tp = ck.save_adapter_only(str(tmp_path / "port"), 2, tpar)
    assert os.path.relpath(jp, tmp_path / "jax") == \
        os.path.relpath(tp, tmp_path / "port") == \
        os.path.join("checkpoint-2", "mm_projector")
    for mod, d in ((ju, "jax"), (ck, "port")):
        latest = mod.latest_checkpoint(str(tmp_path / d))
        assert latest.endswith("checkpoint-2")
        with pytest.raises(FileNotFoundError,
                           match="No structure could be identified"):
            mod.restore_checkpoint(latest, {"params": {}, "step": 0})
    merged = ck.load_adapter_into(
        {"projector.0.weight": torch.zeros(2, 2),
         "image_newline": torch.ones(2), "llada.x": torch.zeros(3)}, tp)
    assert torch.equal(merged["projector.0.weight"], torch.ones(2, 2))
    assert torch.equal(merged["image_newline"], torch.zeros(2))
    assert torch.equal(merged["llada.x"], torch.zeros(3))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_tiny_cli_cuda_resume(cuda, data, tmp_path):
    """The tiny CLI on the card (the kernels: #10 by --attn-impl auto, #1,
    #2): two microsteps and a full save, then a resume whose restored state
    is the first run's, bit for bit, and two more microsteps."""
    from lavida_mod_tpu_torch.ops import prefix_flash as tpf

    out = tmp_path / "run"
    argv = _argv(data, out, "--grad-accum", "2", "--log-every", "1")
    argv[argv.index("cpu")] = "cuda"
    fwd0 = tpf.prefix_flash_fwd.launches
    a = cli.main(argv + ["--steps", "1"])
    assert a["attention_impl"] == "prefix_flash"
    assert tpf.prefix_flash_fwd.launches > fwd0
    final = _snapshot(a["state"])
    del a
    b = cli.main(argv + ["--steps", "1"])
    _same_state(_snapshot(b["state"]), final)
    c = cli.main(argv + ["--steps", "2"])
    assert c["start_step"] == 2 and len(c["losses"]) == 2
    assert all(np.isfinite(c["losses"]))
