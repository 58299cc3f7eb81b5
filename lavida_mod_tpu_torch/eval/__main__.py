"""Eval CLI -- the analogue of `python -m lmms_eval` (eval/lmms_eval/__main__.py);
the port of `python -m lavida_mod_tpu.eval`.

Example (mirrors eval/run_coco.sh):
  python -m lavida_mod_tpu_torch.eval --model-path /ckpts/lavida-llada \\
      --tasks coco2017_cap_val_lite \\
      --gen-kwargs prefix_lm=True,step_ratio=0.5,schedule=shift,schedule__shift=0.33 \\
      --limit 64 --output results.json

Every flag of the JAX CLI with its default, plus `--device` (default
`cuda`; `--device cpu` runs the kernels' plain versions).  A checkpoint
is read by `LaViDa.load` (geometry and LM family sniffed from its
config.json) in bf16 on the device and put in the `--quant` serving layout
there (int4 and mixed fused, as the JAX CLI does); the tokenizer is
`load_hf_or_offline`'s.  `--tiny` serves a seeded f32 toy model (the
JAX CLI's geometry, `predict.tiny_config`) with the JAX CLI's toy
tokenizer.  `--tp N` with --model-path evaluates the bf16 checkpoint
tensor-parallel over N ranks (`LaViDa.shard`; --quant none and no --kv8,
the JAX CLI's refusals in its words): run it under torchrun with N
processes; the documents are shared out over the mesh's dp groups, so
the ranks of one tensor-parallel group score the same documents
together, and rank 0 writes the outputs.  `main(argv)` returns {task:
evaluate()'s output} for callers in process.
"""

from __future__ import annotations

import argparse
import json


def parse_kv(s: str) -> dict:
    out = {}
    if not s:
        return out
    for item in s.split(","):
        k, _, v = item.partition("=")
        v = v.strip()
        if v.lower() in ("true", "false"):
            out[k.strip()] = v.lower() == "true"
        else:
            try:
                out[k.strip()] = int(v)
            except ValueError:
                try:
                    out[k.strip()] = float(v)
                except ValueError:
                    out[k.strip()] = v
    return out


def parse_data_paths(s) -> dict:
    """"task=path,task=path" -> {task: path}."""
    data_paths = {}
    if s:
        for item in s.split(","):
            k, _, v = item.partition("=")
            data_paths[k] = v
    return data_paths


class ToyTokenizer:
    """The tokenizer of `--tiny` (the JAX CLI's): one id per character of
    the first 32, after a BOS; ids decode to their numbers."""

    bos_token_id = 1
    eos_token_id = 2
    chat_template = None

    def __call__(self, text):
        class R:
            input_ids = [1] + [10 + (ord(c) % 80) for c in text[:32]]

        return R()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m lavida_mod_tpu_torch.eval")
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="random-init tiny model + toy tokenizer "
                         "(pipeline smoke runs without a checkpoint)")
    ap.add_argument("--lm-family", default=None, choices=["llada", "dream"],
                    help="default: sniffed from the checkpoint's "
                         "config.json model_type (llada without one)")
    ap.add_argument("--conv-template", default=None)
    ap.add_argument("--tasks", required=True, help="comma-separated")
    ap.add_argument("--data-path", default=None,
                    help="task=path overrides, comma-separated")
    ap.add_argument("--gen-kwargs", default="")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--mc-num", type=int, default=16)
    ap.add_argument("--loglik-act-int8", action="store_true",
                    help="W8A8 kernels for the MC loglikelihood forwards "
                         "under --quant mixed -- opt-in: the activation "
                         "quantization's logit error can flip close "
                         "multiple-choice rankings")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N ranks "
                         "(torchrun; with --model-path, --quant none)")
    ap.add_argument("--quant", choices=["none", "int8", "int4", "mixed"],
                    default="int8",
                    help="LM serving layout for real checkpoints: int8 "
                         "(default; weight-only), int4 (grouped W4A8, "
                         "fused layout), mixed (int8 prefill tree + int4 "
                         "decode tree, fused), or none (bf16)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache + fused decode attention "
                         "(GQA-native; the bench's --kv8 serving "
                         "configuration)")
    ap.add_argument("--log-samples", action="store_true")
    ap.add_argument("--output", default=None)
    ap.add_argument("--output-dir", default=None,
                    help="EvaluationTracker dir: date-stamped results + "
                         "per-sample jsonl per task")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)

    import torch

    from ..models.lavida import LaViDa
    from .adapter import LavidaEvalModel
    from .evaluator import dp_groups, simple_evaluate

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to evaluate on the CPU")
    if args.model_path:
        if args.tp > 1 and args.quant != "none":
            raise SystemExit("--tp is bf16 serving; use --quant none")
        if args.tp > 1 and args.kv8:
            raise SystemExit("--tp is bf16 serving; drop --kv8")
        if args.tp > 1:
            from ..parallel import maybe_init_distributed

            maybe_init_distributed(device)
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
        model = LaViDa.load(args.model_path, lm_family=args.lm_family,
                            device=device)
        if args.tp > 1:
            model.shard(tp=args.tp)
        else:
            # fuse=True: eval generation lengths are task-dependent and
            # unknown up-front; the fused layout is token-exact
            # (adapter.py)
            model.to_serving_layout(quant=args.quant,
                                    fuse=args.quant in ("int4", "mixed"))
        from ..data.tokenizer import load_hf_or_offline

        tokenizer = load_hf_or_offline(args.model_path)
    elif args.tiny:
        from ..predict import tiny_config

        model = LaViDa.random_init(tiny_config(), 0, torch.float32, device)
        model.lm_family = args.lm_family or "llada"
        tokenizer = ToyTokenizer()
    else:
        raise SystemExit("--model-path is required (no checkpoint = no eval)")

    adapter = LavidaEvalModel(
        model, tokenizer,
        conv_template=args.conv_template or model.lm_family,
        mc_num=args.mc_num, kv8=args.kv8,
        loglik_act_int8=args.loglik_act_int8,
    )
    mesh = getattr(model, "mesh", None)
    lead = mesh is None or mesh.get_rank() == 0
    tracker = None
    if args.output_dir and lead:
        from .tracker import EvaluationTracker

        tracker = EvaluationTracker(
            args.output_dir,
            model_name=args.model_path or "tiny",
        )
    with dp_groups(mesh):
        results = simple_evaluate(
            adapter, args.tasks.split(","),
            parse_data_paths(args.data_path), limit=args.limit,
            gen_kwargs=parse_kv(args.gen_kwargs),
            log_samples=args.log_samples or bool(args.output_dir),
            output_path=args.output if lead else None, tracker=tracker,
        )
    if lead:
        print(json.dumps(
            {t: r["results"] for t, r in results.items()}, indent=2,
            default=str))
    return results


if __name__ == "__main__":
    main()
