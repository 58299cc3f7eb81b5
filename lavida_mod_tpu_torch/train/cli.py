"""The training CLI: the port of the repository's train.py (the analogue of
reference llava/train/train.py + its HF Trainer).

    python -m lavida_mod_tpu_torch.train --data-path mix.yaml \\
        --image-folder /data/images --output-dir runs/s2 \\
        --tunable mm_mlp_adapter,mm_vision_tower,mm_language_model \\
        --lr 2e-5 --vision-tower-lr 2e-6 --batch-size 4 --steps 1000

Every flag of train.py, plus `--device` (default `cuda`; the tests pass
`--device cpu`, where the kernels' plain versions run).  What it does, in
train.py's order:
  - geometry (`--geometry` tiny / 457m / 913m / 8b, train.py:182-208) and
    tokenizer (`--tokenizer-path` through `load_hf_or_offline`, else the
    byte-level fallback, :214-231);
  - `SupervisedDataset` over `--data-path` (data/dataset.py);
  - the model: `LaViDa.load` for a directory holding *.safetensors or
    *.bin (a reference-layout checkpoint, :246-250; a training checkpoint
    of this package holds neither, utils/checkpoint.py), else a seeded
    f32 init; then the precision policy (:255-279): "mixed" keeps f32
    masters of the trainable parameters and a bf16 compute model
    (`init_train_state(compute_dtype=bf16)`), "bf16" keeps everything in
    bf16 with an f32 accumulation buffer;
  - resume (:281-291): the newest `checkpoint-N` of `--output-dir` gives
    the model, masters, optimizer state and microstep N (an adapter-only
    directory makes the restore raise, as JAX's orbax does); the numpy
    batch stream restarts from `--seed` (no rng is saved) and each
    microstep's mask generator is seeded from the absolute microstep,
    `seed * 131 + step`;
  - `--attn-impl auto`: prefix_flash (#10) on the card, dense on the CPU;
  - batches (`make_batch`, :319-357): `rng.choice` of B records,
    `get_batch` with the image decode on `--decode-workers` threads,
    `collate_batch`, the gather plan padded to `--seq-bucket` and the
    views to `--view-bucket`; bit-equal to JAX's for the same seed and
    data.  `--prefetch N` runs `--prefetch-workers` producer threads
    (worker 0 keeps the base rng, the others `default_rng([seed, w])`; a
    producer's exception reaches the consumer): they build pinned host
    tensors and the main thread alone copies them to the card;
  - the loop: `--steps` counts optimizer steps of `--grad-accum`
    microsteps; log, save and eval cadences count optimizer steps; logged
    metrics are averaged over the accumulation window, `tokens_per_s` is
    B x T of the padded batches over the log window (:433-451); the last
    microstep always saves (adapter-only or a full async save), and the
    saves are committed before exit; `--profile DIR` traces microsteps 2-4
    of the run (utils/profiling.py).
  - `--eval-tasks` (train.py:454-475): every `--eval-every` optimizer
    steps `train.eval_hook.run_in_training_eval` scores the tasks
    (`--eval-limit` documents each, `--eval-data-path` task=path pairs)
    on the compute model itself -- bf16 under "mixed" (JAX's bf16 cast of
    its masters), its parameters shared, nothing copied back -- with
    `--style` as the template and LM family; the rows {"eval/<task>/
    <metric>": value} go to the metrics logger and are printed.
  - `--dp / --fsdp / --tp` (train.py:240-254): under torchrun with
    dp x fsdp x tp ranks (fsdp absorbs the ranks left when not given), the
    process group comes up from the environment (NCCL on `cuda`, each rank
    on its LOCAL_RANK card; gloo on the CPU), the model is placed on the
    (dp, fsdp, tp) mesh by parallel/sharding's rules and the step takes
    each rank's rows of the global batch over dp x fsdp
    (train/step.py).  Every rank builds the same batches from `--seed`.
    Rank 0 alone logs and writes checkpoints; a checkpoint holds whole
    tensors, gathered from the shards, so a sharded run's checkpoint
    resumes an unsharded run and back.
`--remat` also takes `one_in_N` (the model API's strategy) beside
train.py's choices.  Dropped: JAX's platform switch and
its compile cache.

`main(argv)` returns what the run did (losses, logged rows, eval rows,
the train state, walls, the profile) for callers in process,
chip_smoke.py among them.
"""

from __future__ import annotations

import argparse
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

GEOMETRIES = ("tiny", "457m", "913m", "8b")
REMATS = ("whole_layer", "nested", "dots", "dots_nobatch", "none")


class _NoLogger:
    """The metrics logger of a rank other than 0."""

    def log(self, step: int, metrics: dict) -> None:
        pass

    def close(self) -> None:
        pass


def pad_to_bucket(n: int, bucket: int) -> int:
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


def _remat(value: str) -> str:
    if value in REMATS:
        return value
    tail = value[len("one_in_"):] if value.startswith("one_in_") else ""
    if tail.isdigit() and int(tail) > 0:
        return value
    raise argparse.ArgumentTypeError(
        f"{value!r}: one of {', '.join(REMATS)} or one_in_N")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lavida_mod_tpu_torch.train",
        description="LaViDa training: masked-diffusion loss, AdamW, "
                    "checkpoints and resume, on one card or sharded over "
                    "the ranks of torchrun (--dp / --fsdp / --tp).")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--model-path", default=None,
                    help="initial weights: a reference-layout checkpoint "
                         "directory (*.safetensors or *.bin); anything else "
                         "leaves the seeded init")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--geometry", default=None, choices=GEOMETRIES,
                    help="model geometry when training from scratch: "
                         "'913m' = 12L d2048, llama block, tied head, square "
                         "so400m views; '457m' = its 6-layer half; default "
                         "'8b' (or 'tiny' with --tiny)")
    ap.add_argument("--style", default="llada", choices=["llada", "dream"])
    ap.add_argument("--tunable",
                    default="mm_mlp_adapter,mm_vision_tower,mm_language_model")
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--projector-lr", type=float, default=None)
    ap.add_argument("--vision-tower-lr", type=float, default=None)
    ap.add_argument("--warmup-ratio", type=float, default=0.03)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microsteps per optimizer step; --steps counts "
                         "optimizer steps, so the loop runs steps * "
                         "grad_accum microbatches")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seq-bucket", type=int, default=128)
    ap.add_argument("--view-bucket", type=int, default=8)
    ap.add_argument("--t-policy", default="uniform",
                    choices=["uniform", "logit_normal", "mode"])
    ap.add_argument("--no-prefix-lm", action="store_true")
    ap.add_argument("--fim", action="store_true",
                    help="stage-3 FIM corruption of assistant turns")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks of the (dp, fsdp, tp) mesh")
    ap.add_argument("--fsdp", type=int, default=None,
                    help="parameter-sharding ranks (default: the ranks "
                         "dp x tp leave)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (heads / MLP hidden)")
    ap.add_argument("--decode-workers", type=int, default=4,
                    help="threads for the rng-free image decode inside "
                         "make_batch (0 = sequential); the batches are "
                         "bit-identical either way")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batch queue depth (0 disables): producer threads "
                         "overlap decode, anyres and the gather plan with "
                         "the device step")
    ap.add_argument("--prefetch-workers", type=int, default=1,
                    help="producer threads; 1 keeps the single-rng batch "
                         "stream deterministic, more give each its own "
                         "seeded rng (contents per worker deterministic, "
                         "arrival order not)")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--adapter-only-save", action="store_true")
    ap.add_argument("--eval-tasks", default=None,
                    help="comma-separated lite tasks run every --eval-every "
                         "steps against live params (LLaVAEvalTrainer "
                         "analogue); needs --tokenizer-path + task data")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--eval-limit", type=int, default=32)
    ap.add_argument("--eval-data-path", default=None,
                    help="task=path jsonl overrides, comma-separated")
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--remat", default="whole_layer", type=_remat,
                    help="activation checkpointing: whole_layer, nested "
                         "(sqrt checkpointing), dots, dots_nobatch "
                         "(selective policies), one_in_N or none")
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "dense", "blockwise", "prefix_flash"],
                    help="training attention: auto = prefix_flash (#10) on "
                         "the card, dense on the CPU")
    ap.add_argument("--ce-chunk", type=int, default=None,
                    help="the head and its cross-entropy in checkpointed "
                         "chunks of N positions (512 at 8B)")
    ap.add_argument("--precision", default="mixed", choices=["mixed", "bf16"],
                    help="'mixed': f32 masters, Adam moments and "
                         "accumulation, bf16 forward and backward; 'bf16': "
                         "everything bf16 but the f32 accumulation")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="a torch.profiler trace of microsteps 2-4 to "
                         "DIR/trace.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (default) or cpu")
    return ap


def geometry_config(geometry: str):
    """The LaViDaConfig of a --geometry (train.py:182-208)."""
    from ..config import (LaViDaConfig, LLaDAConfig, VisionConfig,
                          tiny_llada_config, tiny_siglip_config)

    if geometry == "tiny":
        return LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112))))
    if geometry in ("457m", "913m"):
        # scripts/bench_train.py's single-chip geometry: one square 384px
        # so400m view per sample, llama-block LM with a tied head
        return LaViDaConfig(
            llada=LLaDAConfig(
                vocab_size=32000, d_model=2048,
                n_layers=12 if geometry == "913m" else 6,
                n_heads=16, n_kv_heads=16, mlp_hidden_size=6144,
                block_type="llama", activation="silu",
                max_sequence_length=4096, weight_tying=True),
            vision=VisionConfig(image_aspect_ratio="square"))
    return LaViDaConfig()


class ByteTokenizer:
    """The byte-level fallback without --tokenizer-path (train.py:
    214-228)."""

    bos_token_id = 1
    chat_template = None

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([2 + (b % 250) for b in text.encode()])

    def decode(self, ids, skip_special_tokens=True):
        return bytes((int(i) - 2) % 250 for i in ids).decode("latin-1")


def make_batch(ds, cfg, rng: np.random.Generator, batch_size: int,
               seq_bucket: int = 128, view_bucket: int = 8, pool=None,
               pin: bool = False) -> dict:
    """One batch as train.py:319-357 builds it, on the host: rng.choice of
    `batch_size` records (no replacement), `get_batch` (image decode on
    `pool`), `collate_batch` (its extra pad drawn from `rng`), the gather
    plan padded to a multiple of seq_bucket and the views (zeros) to one
    of view_bucket.  Returns {"pixel_values" [NV, C, S, S] bf16 tensor,
    "labels" [B, T] int64 tensor (both pinned with `pin`), "text_ids"
    [B, T_text] and "gather_idx" [B, T] numpy host plans}."""
    import torch

    from ..data.dataset import collate_batch
    from ..models.multimodal import build_gather_plan

    idx = rng.choice(len(ds), size=batch_size, replace=False)
    items = ds.get_batch(idx, pool=pool)
    b = collate_batch(
        items, pad_token_id=cfg.llada.pad_token_id,
        eos_token_id=cfg.llada.eos_token_id,
        model_max_length=cfg.tokenizer_model_max_length, rng=rng)
    n_views = [[v.shape[0] for v in item["images"]] for item in items]
    pix = [v for item in items for v in item["images"]]
    ids_list = [row[m] for row, m in zip(b["input_ids"], b["attention_mask"])]
    labs_list = [row[m] for row, m in zip(b["labels"], b["attention_mask"])]
    plan = (cfg, ids_list, n_views, b["image_sizes"], labs_list)
    gather_idx, text_ids, _, labels = build_gather_plan(*plan)
    T = pad_to_bucket(gather_idx.shape[1], seq_bucket)
    if T > gather_idx.shape[1]:
        gather_idx, text_ids, _, labels = build_gather_plan(*plan, pad_to=T)
    if pix:
        pixel_values = np.concatenate(pix, axis=0)
    else:
        S = cfg.vision.siglip.image_size
        pixel_values = np.zeros((0, 3, S, S), np.float32)
    NV = pad_to_bucket(pixel_values.shape[0], view_bucket)
    if NV > pixel_values.shape[0]:
        padv = np.zeros((NV - pixel_values.shape[0],)
                        + pixel_values.shape[1:], pixel_values.dtype)
        pixel_values = np.concatenate([pixel_values, padv], axis=0)
    out = {"pixel_values": torch.from_numpy(pixel_values).to(torch.bfloat16),
           "labels": torch.from_numpy(labels),
           "text_ids": text_ids, "gather_idx": gather_idx}
    if pin:
        for k in ("pixel_values", "labels"):
            out[k] = out[k].pin_memory()
    return out


def to_device(batch: dict, device) -> dict:
    """The batch's tensors on `device` (from pinned memory without a sync);
    the host plans stay numpy.  Called on the main thread only."""
    import torch

    return {k: v.to(device, non_blocking=True)
            if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


class Prefetcher:
    """Producer threads filling a bounded queue with make_batch's batches
    (train.py:365-404).  `rngs[w]` is worker w's stream.  A producer's
    exception is queued and raised by `next()`.  `close()` stops and joins
    the producers."""

    def __init__(self, produce, rngs, depth: int):
        self._produce = produce
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, len(rngs)))
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(r,),
                                          daemon=True,
                                          name=f"prefetch-{w}")
                         for w, r in enumerate(rngs)]
        for t in self._threads:
            t.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, rng) -> None:
        while not self._stop.is_set():
            try:
                b = self._produce(rng)
            except Exception as e:  # noqa: BLE001 -- handed to the consumer
                self._put(e)
                return
            if not self._put(b):
                return

    def next(self) -> dict:
        b = self._q.get()
        if isinstance(b, Exception):
            raise b
        return b

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            while t.is_alive():
                try:
                    self._q.get(timeout=0.05)      # unblock a full queue
                except queue.Empty:
                    pass
                t.join(timeout=0.05)


def train_payload(state) -> tuple[dict, dict]:
    """(params, opt_state) of a full checkpoint: the compute model's state
    dict, the f32 masters when they are separate (mixed), and the
    optimizer state (Adam moments and counts, the accumulation buffer and
    its index)."""
    params = {"model": dict(state.model.state_dict())}
    if state.compute_dtype is not None:
        params["masters"] = state.masters
    return params, state.opt_state


def adapter_params(state) -> dict:
    """The projector and newline as the checkpoint keeps them: the masters
    (f32 under mixed) where they exist, else the model's."""
    from ..utils.checkpoint import is_adapter_param

    return {n: state.masters.get(n, t)
            for n, t in state.model.state_dict().items() if is_adapter_param(n)}


def _assign(dst: dict, src: dict, path: str = "") -> None:
    """Copy a restored payload into the live one in place (tensors by
    copy_, a sharded one its shard; scalars by item), the keys and shapes
    checked."""
    import torch

    from ..parallel.sharding import copy_full_

    if set(dst) != set(src):
        raise ValueError(f"checkpoint entry {path or '/'!r}: keys "
                         f"{sorted(set(dst) ^ set(src))[:4]} differ from the "
                         f"run's state")
    for k, v in src.items():
        d = dst[k]
        if isinstance(d, dict):
            _assign(d, v, f"{path}/{k}")
        elif isinstance(d, torch.Tensor):
            if d.shape != v.shape:
                raise ValueError(f"checkpoint entry {path}/{k}: shape "
                                 f"{tuple(v.shape)}, the run's "
                                 f"{tuple(d.shape)}")
            with torch.no_grad():
                copy_full_(d, v)
        else:
            dst[k] = v


def restore_train_state(path: str, state) -> int:
    """Load the checkpoint at `path` into `state` in place (a sharded
    state takes each tensor's shard); returns its microstep."""
    import torch

    from ..utils.checkpoint import restore_checkpoint

    payload = restore_checkpoint(path)
    params, opt_state = train_payload(state)
    _assign({"params": params, "opt_state": opt_state},
            {"params": payload["params"], "opt_state": payload["opt_state"]})
    if state.model.image_newline.is_cuda:
        torch.cuda.synchronize()
    return int(payload["step"])


def _load_tokenizer(args):
    from ..utils.logging import rank0_print

    if args.tokenizer_path:
        from ..data.tokenizer import load_hf_or_offline

        return load_hf_or_offline(args.tokenizer_path)
    rank0_print("[train] no tokenizer path: byte-level fallback")
    return ByteTokenizer()


def run_eval(args, cfg, state, tokenizer) -> dict:
    """The in-training eval of train.py:454-475 on the state's compute
    model: under "mixed" it is the bf16 cast of the masters JAX evaluates,
    and under "bf16" the parameters themselves; shared, never copied
    back."""
    from ..eval.__main__ import parse_data_paths
    from .eval_hook import run_in_training_eval

    return run_in_training_eval(
        cfg, state.model, tokenizer, args.eval_tasks.split(","),
        parse_data_paths(args.eval_data_path) or None,
        limit=args.eval_limit, conv_template=args.style,
        lm_family=args.style)


def _build_model(args, cfg, device):
    import torch

    from ..models.lavida import LaViDa
    from ..utils.logging import rank0_print

    p = args.model_path
    if p and os.path.isdir(p) and any(
            f.endswith((".safetensors", ".bin")) for f in os.listdir(p)):
        return LaViDa.load(p, cfg, torch.bfloat16, device=device)
    if p:
        rank0_print(f"[train] --model-path {p} holds no *.safetensors or "
                    f"*.bin weights: the model keeps its seeded init")
    return LaViDa.random_init(cfg, args.seed, torch.float32, device)


def _mesh(args, ap, device):
    """The (dp, fsdp, tp) mesh over the torchrun ranks (train.py:240-243),
    or None for one unsharded process."""
    import torch.distributed as dist

    from ..parallel import make_mesh, maybe_init_distributed

    maybe_init_distributed(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and args.dp * (args.fsdp or 1) * args.tp == 1:
        return None
    if world % (args.dp * args.tp) or (
            args.fsdp and args.dp * args.fsdp * args.tp != world):
        ap.error(f"--dp {args.dp} --fsdp {args.fsdp} --tp {args.tp} does "
                 f"not factor the {world} ranks: run under torchrun with "
                 f"--nproc-per-node dp x fsdp x tp")
    return make_mesh(dp=args.dp, fsdp=args.fsdp, tp=args.tp,
                     device_type=device.type)


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)

    import torch

    from ..constants import LLADA_FIM_ID
    from ..data.dataset import SupervisedDataset
    from ..parallel.sharding import full_tree
    from ..utils.checkpoint import (latest_checkpoint, save_adapter_only,
                                    save_checkpoint, wait_for_saves)
    from ..utils.logging import MetricsLogger, rank0_print
    from .step import (init_train_state, make_freeze_optimizer,
                       make_multimodal_train_step)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to train on the CPU")
    mesh = _mesh(args, ap, device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = mesh is None or mesh.get_rank() == 0
    geometry = args.geometry or ("tiny" if args.tiny else "8b")
    cfg = geometry_config(geometry)
    tokenizer = _load_tokenizer(args)
    ds = SupervisedDataset(
        args.data_path, tokenizer, cfg.vision,
        image_folder=args.image_folder, style=args.style,
        is_infill_model=args.fim, seed=args.seed)
    rank0_print(f"[train] dataset: {len(ds)} samples; geometry {geometry} "
                f"on {device}")

    t_init = time.perf_counter()
    model = _build_model(args, cfg, device)
    if args.precision != "mixed":
        model.to(torch.bfloat16)
    if mesh is not None:
        from ..parallel import shard_params

        shard_params(model, mesh)
        rank0_print(f"[train] mesh: dp {args.dp} x fsdp "
                    f"{mesh.size(1)} x tp {args.tp}")
    opt = make_freeze_optimizer(
        args.tunable, lr=args.lr, projector_lr=args.projector_lr,
        vision_tower_lr=args.vision_tower_lr,
        warmup_steps=int(args.warmup_ratio * args.steps),
        total_steps=args.steps, grad_accum=args.grad_accum,
        accum_dtype=torch.float32 if args.precision == "bf16" else None)
    state = init_train_state(
        model, opt, torch.bfloat16 if args.precision == "mixed" else None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    result = {"init_s": time.perf_counter() - t_init, "state": state,
              "restored_from": None, "restore_s": None}

    start_step = 0
    resume = latest_checkpoint(args.output_dir)
    if resume and not resume.endswith("mm_projector"):
        rank0_print(f"[train] resuming from {resume}")
        t_r = time.perf_counter()
        start_step = restore_train_state(resume, state)
        result.update(restored_from=resume,
                      restore_s=time.perf_counter() - t_r)
        rank0_print(f"[train] restore wall: {result['restore_s']:.1f}s")

    attn_impl = args.attn_impl
    if attn_impl == "auto":
        attn_impl = "prefix_flash" if device.type == "cuda" else "dense"
    rank0_print(f"[train] attention_impl: {attn_impl}")
    step_fn = make_multimodal_train_step(
        cfg, opt, prefix_lm=not args.no_prefix_lm, policy=args.t_policy,
        fim_id=LLADA_FIM_ID if args.fim else None,
        remat=False if args.remat == "none" else args.remat,
        attention_impl=attn_impl, ce_chunk=args.ce_chunk, mesh=mesh)

    logger = (MetricsLogger(args.output_dir, use_wandb=args.wandb) if rank0
              else _NoLogger())
    rng = np.random.default_rng(args.seed)
    decode_pool = (ThreadPoolExecutor(max_workers=args.decode_workers)
                   if args.decode_workers > 0 else None)
    pin = device.type == "cuda"

    def produce(r):
        return make_batch(ds, cfg, r, args.batch_size, args.seq_bucket,
                          args.view_bucket, pool=decode_pool, pin=pin)

    ga = max(1, args.grad_accum)
    total_iters = args.steps * ga
    rank0_print(f"[train] starting at microstep {start_step}/{total_iters}"
                + (f" (grad_accum={ga}, {args.steps} optimizer steps)"
                   if ga > 1 else ""))
    prefetch = None
    if args.prefetch > 0:
        nw = max(1, args.prefetch_workers)
        # worker 0 keeps the base stream: one producer gives the batches
        # of the run without prefetch
        prefetch = Prefetcher(produce, [rng] + [
            np.random.default_rng([args.seed, w]) for w in range(1, nw)],
            args.prefetch)
        next_batch = prefetch.next
    else:
        def next_batch():
            return produce(rng)

    from ..utils.profiling import trace

    profile_ctx = prof = None
    all_metrics, logged, saves, evals = [], [], [], []
    window: list = []
    tokens_since_log = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    try:
        for step in range(start_step, total_iters):
            if args.profile and step == start_step + 1:
                profile_ctx = trace(args.profile)
                prof = profile_ctx.__enter__()
                rank0_print(f"[train] profiler tracing -> {args.profile}")
            batch = to_device(next_batch(), device)
            tokens_since_log += batch["labels"].numel()
            gen = torch.Generator(device=device).manual_seed(
                args.seed * 131 + step)
            metrics = step_fn(state, batch, gen)
            all_metrics.append(metrics)
            if profile_ctx is not None and step == start_step + 3:
                profile_ctx.__exit__(None, None, None)
                profile_ctx = None
                rank0_print(f"[train] profiler trace saved: {prof.path}")
            on_update = (step + 1) % ga == 0
            opt_step = (step + 1) // ga
            window.append(metrics)
            if on_update and opt_step % args.log_every == 0:
                m = {k: float(np.mean([float(w[k]) for w in window]))
                     for k in metrics}
                dt = time.time() - t0
                m["steps_per_s"] = args.log_every / dt
                m["tokens_per_s"] = tokens_since_log / dt
                tokens_since_log = 0
                t0 = time.time()
                logger.log(opt_step, m)
                logged.append({"step": opt_step, **m})
                rank0_print(f"[train] step {opt_step}: loss={m['loss']:.4f} "
                            f"acc_mask={m['acc_mask']:.3f} "
                            f"({m['steps_per_s']:.2f} it/s, "
                            f"{m['tokens_per_s']:.0f} tok/s)")
            if on_update:
                window = []
            if args.eval_tasks and on_update \
                    and opt_step % args.eval_every == 0:
                scores = run_eval(args, cfg, state, tokenizer)
                logger.log(opt_step, scores)
                evals.append({"step": opt_step, **scores})
                rank0_print(f"[train] eval @ {opt_step}: {scores}")
            if (on_update and args.save_every > 0
                    and opt_step % args.save_every == 0) \
                    or step + 1 == total_iters:
                # the payload's step is the MICROSTEP, so a resume replays
                # the exact microbatch position
                t_s = time.perf_counter()
                p = None
                if args.adapter_only_save:
                    if rank0:
                        p = save_adapter_only(args.output_dir, step + 1,
                                              adapter_params(state))
                else:
                    # the whole tensors, gathered by every rank
                    payload = [full_tree(x) for x in train_payload(state)]
                    if rank0:
                        p = save_checkpoint(args.output_dir, step + 1,
                                            *payload, async_save=True)
                saves.append((p, time.perf_counter() - t_s))
                rank0_print(f"[train] saved {p} (staged in "
                            f"{saves[-1][1]:.1f}s)")
    finally:
        if profile_ctx is not None:     # fewer than 3 steps after the first
            profile_ctx.__exit__(None, None, None)
        if prefetch is not None:
            prefetch.close()
        if decode_pool is not None:
            decode_pool.shutdown()
        t_w = time.perf_counter()
        wait_for_saves()    # commit in-flight async saves before exit
        result["commit_s"] = time.perf_counter() - t_w
        logger.close()
        if mesh is not None:
            import torch.distributed as dist

            dist.barrier()      # every rank sees rank 0's checkpoints
    if result["commit_s"] > 0.1:
        rank0_print(f"[train] final save commit: {result['commit_s']:.1f}s")
    result.update(
        start_step=start_step,
        losses=[float(m["loss"]) for m in all_metrics], logged=logged,
        evals=evals,
        saves=saves, profile=prof, attention_impl=attn_impl,
        peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                  if device.type == "cuda" else None))
    return result


if __name__ == "__main__":
    main()
