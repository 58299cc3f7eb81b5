"""One rank of a sharded case of tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py CASE OUT_DIR

Every rank builds the same seeded model and inputs, runs the unsharded
port first (the reference), then shards the model on the case's mesh over
gloo and runs the same call; rank 0 writes both results to
OUT_DIR/result.npz.  `launch(case, n, out_dir, timeout)` starts the n
ranks and returns rank 0's arrays.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(case: str, n: int, out_dir, timeout: float = 60.0,
           argv=(), module=None) -> dict:
    """Start n ranks of `case` (or of `python -m module argv` when module
    is given) and wait; raise with the failing rank's stderr."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        cmd = ([sys.executable, "-m", module, *argv] if module else
               [sys.executable, __file__, case, str(out_dir)])
        procs.append(subprocess.Popen(cmd, env=env, cwd=out_dir,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{e[-4000:]}")
    res = out_dir / "result.npz"
    if module is None:
        with np.load(res) as z:
            return {k: z[k] for k in z.files} | {"stdout": outs[0][0]}
    return {"stdout": [o for o, _ in outs]}


# ---------------------------------------------------------------------------
# the cases (run in the rank's process)
# ---------------------------------------------------------------------------

def _tiny_lm(torch, seed=0):
    from lavida_mod_tpu_torch.config import tiny_llada_config
    from lavida_mod_tpu_torch.models.llada import LLaDA

    lm = LLaDA(tiny_llada_config(), "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if name.endswith("norm.weight") or name == "ln_f.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return lm.eval()


def _prompt(torch, lm, ids):
    with torch.no_grad():
        return lm.embed_tokens(torch.as_tensor(ids))


def _gen_case(torch, mesh_shape, gen_kw, ids, chunk=None):
    """Generate with the unsharded LM, then with it sharded; the prefix is
    embedded by each model (as the JAX tests embed with sharded params)."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.generation import diffusion
    from lavida_mod_tpu_torch.parallel import make_mesh, shard_params

    gen = GenerationConfig(**gen_kw)
    lm = _tiny_lm(torch)
    call = (diffusion.generate if chunk is None else
            lambda m, p, g: diffusion.generate_chunked_prefill(m, p, g,
                                                               chunk=chunk))
    with torch.no_grad():
        ref = call(lm, _prompt(torch, lm, ids), gen)
        steps_ref = _teacher_steps(torch, lm, ids, gen)
        dp, fsdp, tp = mesh_shape
        shard_params(lm, make_mesh(dp=dp, fsdp=fsdp, tp=tp))
        out = call(lm, _prompt(torch, lm, ids), gen)
        steps = _teacher_steps(torch, lm, ids, gen)
    return {"ref": ref.numpy(), "out": out.numpy(),
            "logits_ref": steps_ref, "logits": steps,
            "kv_heads": np.asarray(lm.kv_heads)}


def _teacher_steps(torch, lm, ids, gen):
    """The logits of a full forward over [prompt, x] for a fixed x (half
    the answer masked): the sharded model's next-step inputs, teacher
    forced, to count near-tie flips when the tokens differ."""
    G = gen.max_new_tokens
    B, P = np.asarray(ids).shape
    x = np.full((B, G), lm.cfg.mask_token_id)
    x[:, ::2] = np.asarray(ids)[:, :1] + np.arange(0, G, 2)[None]
    emb = _prompt(torch, lm, np.concatenate([ids, x], axis=1))
    logits, _ = lm(emb)
    return logits[:, P:].numpy()


CASES = {
    # JAX's tests/test_sharded_inference.py meshes
    "generate_fsdp4_tp2": lambda t: _gen_case(
        t, (1, 4, 2), dict(max_new_tokens=16, block_length=8,
                           prefix_lm=True, schedule="shift",
                           schedule_shift=0.33),
        np.arange(5, 17)[None]),
    "generate_full_dp2_fsdp2_tp2": lambda t: _gen_case(
        t, (2, 2, 2), dict(max_new_tokens=8, block_length=8,
                           prefix_lm=False),
        np.arange(3, 12)[None]),
    "chunked_fsdp2_tp4": lambda t: _gen_case(
        t, (1, 2, 4), dict(max_new_tokens=8, block_length=8,
                           prefix_lm=True),
        np.random.default_rng(3).integers(5, 400, size=(5, 12)), chunk=2),
    "batched_tp8": lambda t: _gen_case(
        t, (1, 1, 8), dict(max_new_tokens=8, block_length=8,
                           prefix_lm=True),
        np.random.default_rng(4).integers(5, 400, size=(4, 10))),
}


def _lavida_shard(torch):
    """LaViDa.shard(tp=2, fsdp=2, dp=2) on the composed tiny model:
    tower + projector + LM, one image of 5 views."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.predict import tiny_config

    model = LaViDa.random_init(tiny_config(), 0, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 400, size=12).astype(np.int64)
    ids[4] = -200
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=8, block_length=8, prefix_lm=True)

    def prefixes():
        # the tower's plain MLP, then its fused one (#9's plain version)
        out = []
        for fused in (False, True):
            model.use_vision_fused_mlp = fused
            out.append(model.encode_prompt(ids, [views], [(100, 80)]).numpy())
        model.use_vision_fused_mlp = None
        return out

    ref = model.generate(ids, [views], [(100, 80)], gen)
    ref_prefix, ref_fused = prefixes()
    model.shard(tp=2, fsdp=2, dp=2)
    out = model.generate(ids, [views], [(100, 80)], gen)
    prefix, fused = prefixes()
    sharded = sum(1 for p in model.parameters()
                  if type(p).__name__ == "DTensor"
                  or hasattr(p, "device_mesh"))
    # a plain bf16 tower of lane-aligned width keeps the fused MLP when
    # tp splits fc1 / fc2
    cfg = tiny_config()
    cfg = cfg.replace(vision=dataclasses.replace(
        cfg.vision, siglip=dataclasses.replace(
            cfg.vision.siglip, hidden_size=128, intermediate_size=256)))
    bf16 = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu")
    ok = [bf16.siglip.fused_mlp_ok()]
    bf16.shard(tp=2, fsdp=2, dp=2)
    fc1 = bf16.siglip.layers[0].fc1.weight
    ok += [bf16.siglip.fused_mlp_ok(), fc1.to_local().shape[0] < 256]
    return {"ref": ref, "out": out, "prefix_ref": ref_prefix,
            "prefix": prefix, "fused_ref": ref_fused, "fused": fused,
            "n_sharded": np.asarray(sharded), "fused_ok": np.asarray(ok)}


CASES["lavida_shard_dp2_fsdp2_tp2"] = _lavida_shard


def _train_batch(cfg, B=8):
    """B samples of one view each, an image between a prompt and a
    caption, the plan padded to 48 rows."""
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan

    rng = np.random.default_rng(0)
    S = cfg.vision.siglip.image_size
    ids, views, sizes, labels = [], [], [], []
    for b in range(B):
        row = np.concatenate([rng.integers(3, 400, 3 + b % 3), [-200],
                              rng.integers(3, 400, 14)])
        lab = row.copy()
        lab[:8] = -100
        ids.append(row), labels.append(lab)
        views.append([1]), sizes.append([(S, S)])
    gather_idx, text_ids, _, labs = build_gather_plan(
        cfg, ids, views, sizes, labels, pad_to=48)
    return {"pixel_values": rng.standard_normal(
        (B, 3, S, S)).astype(np.float32), "text_ids": text_ids,
        "gather_idx": gather_idx, "labels": labs}


def _train(torch):
    """make_multimodal_train_step at dp 2 x fsdp 2 x tp 2 (tests/
    test_train.py:90-121): the unsharded step first from a copy of the
    model (the reference), then 5 sharded steps; the first step's mask is
    injected in both, the others drawn from the same generators."""
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.parallel import make_mesh, shard_params
    from lavida_mod_tpu_torch.parallel.sharding import full_tree
    from lavida_mod_tpu_torch.predict import tiny_config
    from lavida_mod_tpu_torch.train import step as tstep

    cfg = tiny_config()
    batch = _train_batch(cfg)
    rng = np.random.default_rng(1)
    labs = batch["labels"]
    mask = torch.from_numpy(rng.random(labs.shape) < 0.5)

    def fresh():
        return LaViDa.random_init(cfg, 0, torch.float32, "cpu")

    opt = tstep.make_freeze_optimizer(
        "mm_mlp_adapter,mm_vision_tower,mm_language_model", lr=1e-2,
        warmup_steps=0, total_steps=10)

    class Recorder(tstep.Optimizer):
        """Keeps the step's gradients (whole tensors) and updates
        nothing."""

        def step(self, grads, state, params):
            self.grads = full_tree({n: g.detach() for n, g in grads.items()})
            return True

    rec = Recorder(opt.label, opt.groups)
    ref_model = fresh()
    tstep.make_multimodal_train_step(cfg, rec, remat=True)(
        tstep.init_train_state(ref_model, rec), batch, masked_indices=mask)
    ref_grads = rec.grads
    state = tstep.init_train_state(ref_model, opt)
    step = tstep.make_multimodal_train_step(cfg, opt, remat=True)
    ref_m = step(state, batch, masked_indices=mask)

    model = fresh()
    mesh = make_mesh(dp=2, fsdp=2, tp=2)
    shard_params(model, mesh)
    tstep.make_multimodal_train_step(cfg, rec, remat=True, mesh=mesh)(
        tstep.init_train_state(model, rec), batch, masked_indices=mask)
    state = tstep.init_train_state(model, opt)
    step = tstep.make_multimodal_train_step(cfg, opt, remat=True, mesh=mesh,
                                            batch_axes=("dp", "fsdp"))
    m0 = step(state, batch, masked_indices=mask)
    losses, norms = [float(m0["loss"])], [float(m0["grad_norm"])]
    for i in range(1, 5):
        gen = torch.Generator().manual_seed(i)
        m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": np.asarray(losses), "norms": np.asarray(norms),
           "ref_loss": np.asarray(float(ref_m["loss"])),
           "ref_norm": np.asarray(float(ref_m["grad_norm"])),
           "num_sup": np.asarray([float(m0["num_supervised"]),
                                  float(ref_m["num_supervised"])]),
           "n_dtensor": np.asarray(sum(
               1 for p in model.parameters() if hasattr(p, "device_mesh")))}
    for n, g in rec.grads.items():
        out["grad/" + n] = g.numpy()
        out["ref/" + n] = ref_grads[n].numpy()
    return out


CASES["train_dp2_fsdp2_tp2"] = _train


def _cli(torch):
    """The training CLI at dp 2 x fsdp 2 x tp 2 in each rank's process:
    4 steps with saves at 2 and 4 into sharded/, then a second run into it
    (a resume with no step left) whose state must equal checkpoint-4 bit
    for bit; and a resume of unsharded/checkpoint-2 (written by one
    process) likewise.  The data and unsharded/ are the test's."""
    from lavida_mod_tpu_torch.parallel.sharding import full_tree
    from lavida_mod_tpu_torch.train import cli
    from lavida_mod_tpu_torch.utils.checkpoint import restore_checkpoint

    def argv(out, steps):
        return ["--tiny", "--device", "cpu", "--data-path",
                "syn/data.json", "--image-folder", "syn/images",
                "--output-dir", out, "--batch-size", "4", "--lr", "1e-3",
                "--steps", str(steps), "--save-every", "2",
                "--log-every", "1", "--prefetch", "0", "--dp", "2",
                "--fsdp", "2", "--tp", "2"]

    def same_as_file(run, path):
        """The run's whole payload against the checkpoint's tensors."""
        params, opt = (full_tree(x) for x in cli.train_payload(run["state"]))
        want = restore_checkpoint(path)
        bad = []

        def walk(a, b, where):
            if isinstance(b, dict):
                if set(a) != set(b):
                    bad.append(where + ":keys")
                for k in b:
                    walk(a[k], b[k], f"{where}/{k}")
            elif isinstance(b, torch.Tensor):
                if not torch.equal(a.cpu(), b):
                    bad.append(where)
            elif a != b:
                bad.append(where)

        walk({"params": params, "opt_state": opt},
             {"params": want["params"], "opt_state": want["opt_state"]}, "")
        return bad, int(want["step"])

    first = cli.main(argv("sharded", 4))
    again = cli.main(argv("sharded", 4))
    bad, step = same_as_file(again, "sharded/checkpoint-4")
    back = cli.main(argv("unsharded", 2))
    bad_back, step_back = same_as_file(back, "unsharded/checkpoint-2")
    return {"losses": np.asarray(first["losses"]),
            "restored": np.asarray([again["start_step"], step,
                                    back["start_step"], step_back]),
            "mismatch": np.asarray(len(bad) + len(bad_back)),
            "first_bad": np.asarray(str((bad + bad_back)[:3]))}


CASES["cli_dp2_fsdp2_tp2"] = _cli


def _lockstep(torch):
    """Rank 0 owns the calls (parallel/lockstep.py): three calls of a
    model-like object on rank 0, replayed by rank 1 in order; a line
    broadcast from rank 0."""
    import torch.distributed as dist

    from lavida_mod_tpu_torch.parallel.lockstep import (Lockstep, broadcast,
                                                        follow)

    class Model:
        def __init__(self):
            self.seen = []

        def generate_until(self, text, k=1):
            t = torch.tensor([float(len(text) * k)])
            dist.all_reduce(t)          # a collective, as a sharded forward
            self.seen.append((text, k, float(t)))
            return float(t)

        def name(self):
            return "not broadcast"

    m = Model()
    line = broadcast("hello" if dist.get_rank() == 0 else None)
    if dist.get_rank() == 0:
        lock = Lockstep(m, ("generate_until",))
        outs = [lock.generate_until("ab"), lock.generate_until("abc", k=2),
                lock.generate_until("x")]
        assert lock.name() == "not broadcast"
        lock.close()
        n = len(outs)
    else:
        n = follow(m)
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, m.seen)
    return {"line": np.asarray(line), "n": np.asarray(n),
            "same": np.asarray(seen[0] == seen[1]),
            "sums": np.asarray([s[2] for s in seen[0]])}


CASES["lockstep"] = _lockstep


def main(case: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        res = CASES[case](torch)
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "result.npz"),
                     **{k: np.asarray(v) for k, v in res.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1], sys.argv[2])
