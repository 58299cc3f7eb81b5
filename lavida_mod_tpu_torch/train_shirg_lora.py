"""The SHIRG Extra-LoRA training harness: the port of
scripts/train_shirg_lora.py (shirg/train_shirg_lora.py:86-1145 and
shirg_lora_config.py:17-140 of the reference).

    python -m lavida_mod_tpu_torch.train_shirg_lora --data-path data.json \\
        --image-folder images --output-dir runs/shirg [--tiny] \\
        [--steps 100] [--batch-size 2] [--lr 1.8e-5] [--warmup-steps 500] \\
        [--device cuda]

Every flag of the script, plus `--device` (default `cuda`; the tests pass
`--device cpu`, where the kernels' plain versions run):
  - the model: `LaViDaConfig()` (LLaDA-8B + SigLIP so400m; the 2-layer toy
    with --tiny) in f32, as the script runs it, from `--model-path`
    (`LaViDa.load`) or a seeded init (`--seed`);
  - `add_shirg_lora` (rank `--rank`, alpha `--alpha`; projector, SigLIP
    q/k/v gated to blocks 0-5 / 0-3) from seed `--seed + 1`; the
    trainable count includes the inert factors, as the script's does;
  - `make_lora_optimizer(lr, weight_decay 0.01, grad clip 1.0,
    --warmup-steps, total --steps)`: warmup from lr 0, then cosine;
  - batches as the script builds them (:117-162): `rng.choice` of
    `--batch-size` records from a numpy generator seeded with --seed, the
    two 448^2 SHIRG views (`process_shirg_2view`; with --tiny the toy
    tower's size: a square resize and the processor's own resize), the
    prompt and answer through the byte `encode_text` into `--text-bucket`
    ids, labels -100 over the image and the prompt;
  - one `make_shirg_lora_train_step` per step, the diffusion mask drawn
    from a generator seeded with the step (the script's PRNGKey(step));
  - adapter-only saves every `--save-every` steps and at the last:
    `split_lora_state` under `checkpoint-N` of `--output-dir`
    (utils/checkpoint.py; JAX's `/` in the paths stored as `.`), reloaded
    by `load_adapters`.
  - with `--eval-every` and `--eval-tasks`, every `--eval-every` steps
    `run_in_training_eval` on the live model, as the script calls it
    (:178-185): no tokenizer, no data paths (each task's documents from
    its HF dataset through `datasets`), `--eval-limit` documents.  Without
    `datasets` that load raises ModuleNotFoundError, as the script's does
    (ROADMAP.md Queue 3).

Before the first step the peak device memory is reckoned and printed
(`reckon_peak`): the weights, the LoRA factors' gradient and Adam state,
the tower's activations (no remat, f32), the LM's (per-layer remat), the
logits and the two largest frozen gradients (each is freed as soon as its
norm is taken, train/step.py).  `main(argv)` returns the run (losses,
grad norms, the state and optimizer, walls, peaks, checkpoint paths).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def adapter_payload(lora_state: dict) -> dict:
    """split_lora_state's {JAX path: factors} as a checkpoint tree (keys
    without '/': JAX paths hold no '.', so '/' is stored as '.')."""
    return {path.replace("/", "."): dict(f) for path, f in lora_state.items()}


def load_adapters(path: str) -> dict:
    """The {JAX path: factors} saved under checkpoint directory `path`."""
    from .utils.checkpoint import restore_checkpoint

    lora = restore_checkpoint(path)["params"]["lora"]
    return {k.replace(".", "/"): v for k, v in lora.items()}


def reckon_peak(model, batch: int, text_len: int, view_tokens: int,
                n_img: int) -> dict:
    """The step's peak device bytes, reckoned from the shapes (see the
    module note): each part and the "total"."""
    cfg = model.cfg
    f = 4                                  # the harness trains in f32
    lora = sum(p.numel() for n, p in model.named_parameters()
               if n.endswith((".lora_a", ".lora_b")))
    frozen = sorted((p.numel() for n, p in model.named_parameters()
                     if not n.endswith((".lora_a", ".lora_b"))),
                    reverse=True)
    sc = cfg.vision.siglip
    D, I = sc.hidden_size, sc.intermediate_size
    # per layer and token: ln1 out, q, k, v, attention out, the residual,
    # ln2 out (7 D), fc1 out and the tanh-GELU's intermediates (3 I)
    tower = sc.n_layers_used * 2 * batch * view_tokens * (7 * D + 3 * I) * f
    lc = cfg.llada
    T = n_img + text_len
    # per-layer remat: each layer's input, one layer recomputed (~6 D + 3 H
    # per row) and its [T, T] scores and probabilities
    lm = batch * T * (lc.n_layers * lc.d_model + 6 * lc.d_model
                      + 3 * lc.mlp_hidden_size) * f
    lm += 2 * batch * lc.n_heads * T * T * f
    out = {"weights": sum(p.numel() * p.element_size()
                          for p in model.parameters()),
           "lora_state": 3 * lora * f, "tower_activations": tower,
           "lm_activations": lm,
           "logits": 3 * batch * T * lc.vocab_size * f,
           "frozen_grads": sum(frozen[:2]) * f}
    out["total"] = sum(out.values())
    return out


def main(argv=None, on_ready=None) -> dict:
    """Run the harness; `on_ready(model)`, when given, is called once the
    adapted model is built, before the first step (a caller's snapshot)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-path", required=True,
                    help="llava-style json (conversations + image)")
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--lr", type=float, default=1.8e-5)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=128.0)
    ap.add_argument("--warmup-steps", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--text-bucket", type=int, default=64)
    ap.add_argument("--shirg-method", default="full")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--eval-tasks", default=None)
    ap.add_argument("--eval-limit", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from .config import LaViDaConfig, VisionConfig, tiny_llada_config, \
        tiny_siglip_config
    from .data import SigLIPImageProcessor
    from .models.lavida import LaViDa
    from .models.shirg import process_shirg_2view, shirg_token_count
    from .train.lora import (add_shirg_lora, make_lora_optimizer,
                             make_shirg_lora_train_step, split_lora_state)
    from .train.step import init_train_state
    from .utils.checkpoint import save_checkpoint

    device = torch.device(args.device)
    if args.tiny:
        cfg = LaViDaConfig(llada=tiny_llada_config(),
                           vision=VisionConfig(siglip=tiny_siglip_config(),
                                               mm_hidden_size=32))
        view_size = cfg.vision.siglip.image_size
    else:
        cfg = LaViDaConfig()
        view_size = 448
    t0 = time.perf_counter()
    if args.model_path:
        model = LaViDa.load(args.model_path, cfg, torch.float32,
                            device=device)
    else:
        model = LaViDa.random_init(cfg, args.seed, torch.float32, device)
    add_shirg_lora(model, args.seed + 1, rank=args.rank, alpha=args.alpha)
    init_s = time.perf_counter() - t0
    n_lora = sum(p.numel() for n, p in model.named_parameters()
                 if n.endswith((".lora_a", ".lora_b")))
    print(f"[shirg-lora] trainable LoRA params: {n_lora / 1e6:.2f}M "
          f"(model ready in {init_s:.1f} s)")

    if on_ready is not None:
        on_ready(model)
    opt = make_lora_optimizer(lr=args.lr, weight_decay=0.01, grad_clip=1.0,
                              warmup_steps=args.warmup_steps,
                              total_steps=args.steps)
    state = init_train_state(model, opt)
    step_fn = make_shirg_lora_train_step(cfg, opt,
                                         shirg_method=args.shirg_method)

    with open(args.data_path) as f:
        records = json.load(f)
    proc = SigLIPImageProcessor(size=view_size)
    rng = np.random.default_rng(args.seed)

    def encode_text(s: str) -> list[int]:
        return [2 + (b % 250) for b in s.encode()][:args.text_bucket]

    view_tokens = (view_size // cfg.vision.siglip.patch_size) ** 2
    n_img = shirg_token_count(view_tokens)

    def make_batch():
        idx = rng.choice(len(records), size=args.batch_size,
                         replace=len(records) < args.batch_size)
        pix, text_ids, labels = [], [], []
        for i in idx:
            r = records[int(i)]
            img = Image.open(os.path.join(
                args.image_folder, r["image"])).convert("RGB")
            if args.tiny:
                views = np.stack([proc(img.resize((view_size,) * 2)),
                                  proc(img)], axis=0)
            else:
                views = process_shirg_2view(img, proc)
            pix.append(views)
            prompt = r["conversations"][0]["value"].replace("<image>", "")
            answer = r["conversations"][1]["value"]
            p_ids, a_ids = encode_text(prompt), encode_text(answer)
            ids = (p_ids + a_ids)[:args.text_bucket]
            ids = ids + [cfg.llada.pad_token_id] * (args.text_bucket
                                                    - len(ids))
            lab = [-100] * len(p_ids) + ids[len(p_ids):]
            lab = lab[:args.text_bucket]
            lab += [-100] * (args.text_bucket - len(lab))
            text_ids.append(ids)
            labels.append(lab)
        lab_full = np.concatenate(
            [np.full((len(idx), n_img), -100, np.int64),
             np.asarray(labels, np.int64)], axis=1)
        return {"pixel_values": torch.from_numpy(np.stack(pix)),
                "text_ids": torch.from_numpy(np.asarray(text_ids,
                                                        np.int64)),
                "labels": torch.from_numpy(lab_full)}

    cuda = device.type == "cuda"
    peak_plan = reckon_peak(model, args.batch_size, args.text_bucket,
                            view_tokens, n_img)
    print(f"[shirg-lora] reckoned peak {peak_plan['total'] / 1e9:.2f} GB = "
          + " + ".join(f"{k} {v / 1e9:.2f}" for k, v in peak_plan.items()
                       if k != "total"))
    print(f"[shirg-lora] {len(records)} samples, {args.steps} steps, lr "
          f"{args.lr}")
    losses, norms, walls, peaks, saved = [], [], [], [], []
    t_log = time.perf_counter()
    for step in range(args.steps):
        batch = make_batch()
        gen = torch.Generator(device=device).manual_seed(step)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, gen)
        loss = float(metrics["loss"])
        walls.append(time.perf_counter() - t0)
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated(device))
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        if (step + 1) % 10 == 0 or step + 1 == args.steps:
            n = (step % 10) + 1
            print(f"[shirg-lora] step {step + 1}: loss={loss:.4f} "
                  f"grad_norm={norms[-1]:.4f} "
                  f"({n / (time.perf_counter() - t_log):.2f} it/s)")
            t_log = time.perf_counter()
        if args.eval_every and (step + 1) % args.eval_every == 0 \
                and args.eval_tasks:
            from .train.eval_hook import run_in_training_eval

            scores = run_in_training_eval(
                cfg, model, None, args.eval_tasks.split(","),
                None, limit=args.eval_limit)
            print(f"[shirg-lora] eval @ {step + 1}: {scores}")
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            path = save_checkpoint(
                args.output_dir, step + 1,
                {"lora": adapter_payload(split_lora_state(model))},
                extra={"rank": args.rank, "alpha": args.alpha})
            saved.append(path)
            print(f"[shirg-lora] saved adapters -> {path}")
    print("[shirg-lora] done")
    return {"losses": losses, "grad_norms": norms, "state": state,
            "optimizer": opt,
            "walls": walls, "peaks": peaks, "saved": saved,
            "peak_plan": peak_plan, "n_lora": n_lora, "init_s": init_s}


if __name__ == "__main__":
    main()
