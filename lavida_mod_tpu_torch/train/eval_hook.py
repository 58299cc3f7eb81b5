"""In-training evaluation hook: the port of lavida_mod_tpu/train/eval_hook.py.

The analogue of LLaVAEvalTrainer (reference llava/train/
llava_eval_trainer.py:202-529): every eval interval, run lmms-eval-style
lite tasks against the CURRENT training parameters and log the scores --
the continuous quality signal the reference streams to wandb
(--lmms_eval_generate_tasks, gen defaults max_new_tokens=16,
prefix_lm=True, llava_eval_trainer.py:371-375).

The eval model is a view of the training `LaViDa`: a shallow copy that
shares its modules and parameters (no weight is copied, nothing is written
back), with the given config and LM family.  Generation runs under
torch.no_grad, so the eval adds nothing to autograd and leaves the
training state as it was.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

from ..config import LaViDaConfig, as_port_config
from ..eval.adapter import LavidaEvalModel
from ..eval.evaluator import (dp_groups, evaluate, rank_and_world,
                              shard_docs)
from ..eval.tasks import get_task


DEFAULT_GEN_KWARGS = {"max_new_tokens": 16, "prefix_lm": True}


def eval_view(model, cfg: LaViDaConfig, lm_family: str = "llada"):
    """The training model as the eval sees it: the same parameters under
    `cfg` and `lm_family` (JAX's LaViDa(cfg, params, lm_family))."""
    view = copy.copy(model)
    view.cfg = as_port_config(cfg)
    view.lm_family = lm_family
    return view


def run_in_training_eval(
    cfg: LaViDaConfig,
    params,
    tokenizer,
    tasks: Sequence[str],
    data_paths: Optional[dict] = None,
    limit: Optional[int] = 32,
    conv_template: str = "llada",
    lm_family: str = "llada",
    gen_kwargs: Optional[dict] = None,
) -> dict:
    """params: the training `LaViDa` (its parameters are shared, not
    copied); a sharded one's documents go out over its mesh's dp
    groups.  Returns {f"eval/{task}/{metric}": float} for the metrics
    logger."""
    model = eval_view(params, cfg, lm_family)
    adapter = LavidaEvalModel(model, tokenizer, conv_template=conv_template)
    # a sharded model's tp / fsdp groups score the same documents
    with dp_groups(getattr(params, "mesh", None)):
        distributed = rank_and_world()[1] > 1
        flat = {}
        for name in tasks:
            task = get_task(name)
            # each rank scores a strided shard; rows are gathered and (for
            # mme) pair-deduped before aggregation -- the reference's
            # all_gather_object merge loop (llava_eval_trainer.py:232-292)
            docs = shard_docs(task.load_docs(
                (data_paths or {}).get(name), limit=limit
            ))
            out = evaluate(
                adapter, task, docs,
                gen_kwargs={**DEFAULT_GEN_KWARGS, **(gen_kwargs or {})},
                distributed=distributed,
            )
            for k, v in out["results"].items():
                if isinstance(v, (int, float)):
                    flat[f"eval/{name}/{k}"] = float(v)
        return flat
