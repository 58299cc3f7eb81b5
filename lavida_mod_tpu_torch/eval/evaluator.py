"""Evaluator core (reference eval/lmms_eval/evaluator.py:50-654 semantics):
task -> docs -> model requests -> per-doc scoring -> aggregation.

The port of lavida_mod_tpu/eval/evaluator.py: `evaluate`,
`simple_evaluate` and `mme_dedup_rows` are its code; `shard_docs` and
`allgather_rows` take the rank and world size of the torch.distributed
process group instead of JAX's processes (strided shards; rows gathered
with `all_gather_object`, in rank order), and are the identity when no
group is initialised or it has one rank.  Inside `dp_groups(mesh)` they
share documents over a sharded model's dp groups instead of raw ranks.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional, Sequence

import numpy as np

from .adapter import LavidaEvalModel
from .tasks import Task, get_task


def evaluate(
    model: LavidaEvalModel,
    task: Task,
    docs: Sequence[dict],
    gen_kwargs: Optional[dict] = None,
    log_samples: bool = False,
    progress: bool = True,
    batch_size: int = 1,
    distributed: bool = False,
) -> dict:
    """distributed=True gathers every process's score rows before
    aggregation (the reference's dist.all_gather_object merge,
    llava_eval_trainer.py:268-292) and applies the MME pairwise dedup."""
    rows = []
    samples = []
    merged_kwargs = dict(task.generation_kwargs)
    merged_kwargs.update(gen_kwargs or {})
    t_start = time.perf_counter()

    if task.output_type == "generate_until" and batch_size > 1:
        preds: list[str] = []
        for lo in range(0, len(docs), batch_size):
            chunk = docs[lo : lo + batch_size]
            if any(d.get("is_video") for d in chunk):
                # video docs carry per-doc frame stacks through the
                # video encode path — serve them per-doc (the reference
                # eval loops batch=1 for everything anyway)
                preds.extend(
                    model.generate_until(
                        task.doc_to_text(d), d.get("images", []),
                        merged_kwargs, video=bool(d.get("is_video")))
                    for d in chunk)
                continue
            preds.extend(model.generate_until_batch(
                [task.doc_to_text(d) for d in chunk],
                [d.get("images", []) for d in chunk],
                merged_kwargs,
            ))
            if progress:
                print(f"[eval:{task.name}] {min(lo + batch_size, len(docs))}"
                      f"/{len(docs)}", flush=True)
        for doc, pred in zip(docs, preds):
            pred = task.apply_filters(pred, doc)
            row = (task.score_doc(doc, pred) if task.score_doc
                   else {"pred": pred})
            rows.append(row)
            if log_samples:
                samples.append({"id": doc.get("id"), "prediction": pred,
                                **row})
        if distributed:
            rows = allgather_rows(rows)
            if task.name == "mme":
                rows = mme_dedup_rows(rows)
        results = task.aggregate(rows) if task.aggregate else {}
        results.update(
            avg_latency_s=model.avg_latency,
            wall_s=time.perf_counter() - t_start, n_docs=len(docs),
        )
        out = {"task": task.name, "results": results}
        if log_samples:
            out["samples"] = samples
        return out

    for i, doc in enumerate(docs):
        text = task.doc_to_text(doc)
        if task.output_type == "generate_until":
            if doc.get("is_video"):
                pred = model.generate_until(text, doc.get("images", []),
                                            merged_kwargs, video=True)
            else:
                pred = model.generate_until(text, doc.get("images", []),
                                            merged_kwargs)
            pred = task.apply_filters(pred, doc)
        elif "choices" in doc:
            # multiple-choice loglikelihood protocol: score every choice,
            # predict the argmax (lmms-eval loglikelihood requests)
            lls = [
                model.loglikelihood(text, doc.get("images", []), str(c))
                for c in doc["choices"]
            ]
            pred = str(doc["choices"][int(np.argmax(lls))])
        else:
            pred = model.loglikelihood(text, doc.get("images", []),
                                       str(doc["target"]))
        row = task.score_doc(doc, pred) if task.score_doc else {"pred": pred}
        rows.append(row)
        if log_samples:
            samples.append({"id": doc.get("id", i), "text": text,
                            "prediction": pred, **row})
        if progress and (i + 1) % 25 == 0:
            print(f"[eval:{task.name}] {i + 1}/{len(docs)} "
                  f"avg_latency={model.avg_latency:.3f}s", flush=True)
    if distributed:
        rows = allgather_rows(rows)
        if task.name == "mme":
            rows = mme_dedup_rows(rows)
    results = task.aggregate(rows) if task.aggregate else {}
    results["avg_latency_s"] = model.avg_latency
    results["wall_s"] = time.perf_counter() - t_start
    results["n_docs"] = len(docs)
    out = {"task": task.name, "results": results}
    if log_samples:
        out["samples"] = samples
    return out


# the mesh of the sharded model under evaluation, set only inside
# `dp_groups`
_MESH: list = [None]


@contextlib.contextmanager
def dp_groups(mesh):
    """Within the block, `rank_and_world`, `shard_docs` and
    `allgather_rows` share documents out over `mesh`'s dp groups (None:
    over the ranks of the default group): the ranks of one tensor-parallel
    / fsdp group run the model together, so they must score the same
    documents.  `evaluate` and `simple_evaluate` are the JAX package's
    code, which calls those three with no mesh; the block hands them the
    sharded model's for one call and restores the previous one on
    leaving."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        yield
    finally:
        _MESH[0] = prev


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default torch.distributed group; (0, 1)
    when none is initialised.  Inside `dp_groups`, this rank's dp
    coordinate and the dp size."""
    import torch.distributed as dist

    mesh = _MESH[0]
    if mesh is not None:
        i = mesh.mesh_dim_names.index("dp")
        return mesh.get_coordinate()[i], mesh.size(i)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def allgather_rows(rows: list) -> list:
    """Gather python score rows from every rank (the reference's
    dist.all_gather_object merge, llava_eval_trainer.py:268-292): each
    rank's rows travel as json (default=str, as the JAX package sends
    them) and are deserialized in rank order, the same on every rank, so
    every rank aggregates the same rows.  One process: identity.  Inside
    `dp_groups`, over the mesh's dp group."""
    _, n = rank_and_world()
    if n <= 1:
        return list(rows)
    import torch.distributed as dist

    gathered: list = [None] * n
    mesh = _MESH[0]
    dist.all_gather_object(gathered, json.dumps(rows, default=str),
                           group=None if mesh is None
                           else mesh.get_group("dp"))
    out: list = []
    for part in gathered:
        out.extend(json.loads(part))
    return out


def mme_dedup_rows(rows: list) -> list:
    """MME strictly scores image PAIRS; distributed loaders can duplicate
    docs, so keep at most two rows per question_id
    (llava_eval_trainer.py:513-529)."""
    from collections import defaultdict

    seen: dict = defaultdict(int)
    out = []
    for r in rows:
        qid = r.get("question_id", r.get("image_id"))
        if seen[qid] >= 2:
            continue
        out.append(r)
        seen[qid] += 1
    return out


def shard_docs(docs: Sequence[dict]) -> Sequence[dict]:
    """Data-parallel eval: each rank scores a strided shard (the
    reference's 8-proc accelerate DDP loop, eval adapter
    llava_llada.py:174-198).  One process: identity.  Metric aggregation
    across ranks is the caller's job (allgather_rows).  Inside
    `dp_groups`, the shards go to the mesh's dp groups."""
    rank, n = rank_and_world()
    if n <= 1:
        return docs
    return docs[rank::n]


def simple_evaluate(
    model: LavidaEvalModel,
    tasks: Sequence[str],
    data_paths: Optional[dict] = None,
    limit: Optional[int] = None,
    gen_kwargs: Optional[dict] = None,
    log_samples: bool = False,
    output_path: Optional[str] = None,
    batch_size: int = 1,
    tracker=None,
) -> dict:
    """Run several tasks; returns {task: results}.  data_paths maps task
    name -> local jsonl/dataset override.  `tracker`: an
    eval.tracker.EvaluationTracker — saves date-stamped aggregated results
    and per-sample jsonl under its output dir (the reference's
    evaluation_tracker layer)."""
    all_results = {}
    for name in tasks:
        task = get_task(name)
        docs = shard_docs(task.load_docs(
            (data_paths or {}).get(name), limit=limit
        ))
        all_results[name] = evaluate(
            model, task, docs, gen_kwargs, log_samples,
            batch_size=batch_size,
        )
    if output_path:
        with open(output_path, "w") as f:
            json.dump(all_results, f, indent=2, default=str)
    if tracker is not None:
        tracker.save_results_aggregated(
            {t: r.get("results", r) for t, r in all_results.items()},
            samples={t: r["samples"] for t, r in all_results.items()
                     if "samples" in r},
        )
    return all_results
