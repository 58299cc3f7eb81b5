"""Checkpoints of the training CLI: the port of
lavida_mod_tpu/utils/checkpoint.py, with its API and semantics and without
orbax (a JAX library).

A checkpoint is the directory `<output_dir>/checkpoint-<step>` holding
  tensors.sft   every tensor of the payload, in the safetensors layout
                (tools/safetensors_io.py), under its path in the payload
                ("opt_state/groups/base/mu/llada.wte.weight");
  meta.json     the payload's structure: nested dicts whose leaves are
                JSON scalars (the step, Adam counts, the accumulation
                index) or {"__tensor__": name}.
The payload `save_checkpoint` writes is {"params": ..., "step": N} plus
"opt_state" and "extra" when given, each a nested dict of tensors and
scalars; the training CLI's is the model's state dict, the f32 masters,
the optimizer state (per LR group the Adam moments and count, the
accumulation buffer and its index) and the microstep.

The tensor file is deliberately not named *.safetensors (nor *.bin):
`--model-path` takes a directory holding such files for a reference-layout
checkpoint (the JAX train.py:246-250 test, kept by the port's CLI).  So a
training checkpoint given as `--model-path` holds no reference weights:
as in the JAX package, the model then keeps its seeded init (the CLI
prints that); a run resumes from `--output-dir` instead.

Writes are atomic: a checkpoint is written into `checkpoint-<step>.tmp-*`
beside its place and renamed when complete, replacing an older directory
of the same step, so a process killed mid-write leaves no directory that
`latest_checkpoint` takes.  `save_checkpoint(..., async_save=True)` copies
every tensor to host memory on the caller's thread (so a later in-place
update does not reach the saved copy) and writes on one background
thread: successive saves commit in the order they were made.
`wait_for_saves()` blocks until every one has committed and raises the
first failure; call it before exit and before reading a checkpoint the
same process has just saved.

`save_adapter_only` writes the projector and `image_newline` alone under
`checkpoint-<step>/mm_projector` (stage 1); `load_adapter_into` merges
one into a state dict.  As in the JAX package, `latest_checkpoint` then
returns `checkpoint-<step>`, never the `mm_projector` path, and
`restore_checkpoint` of that directory raises FileNotFoundError: it holds
no full payload (JAX's orbax raises the same, "No structure could be
identified for the checkpoint").
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import torch

from ..tools.safetensors_io import SafetensorsFile, save_file

TENSORS = "tensors.sft"
META = "meta.json"
ADAPTER = "mm_projector"
_FORMAT = "lavida_mod_tpu_torch checkpoint 1"


class _AsyncSaver:
    """One background writer thread; futures kept until waited on."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-save")
        self._pending: list[Future] = []
        self._lock = threading.Lock()

    def submit(self, fn, *args) -> None:
        with self._lock:
            self._pending.append(self._pool.submit(fn, *args))

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()          # raises the save's exception


_SAVER: Optional[_AsyncSaver] = None
_TMP_IDS = itertools.count()


def wait_for_saves() -> None:
    """Block until every in-flight async save has committed."""
    if _SAVER is not None:
        _SAVER.wait()


def _ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{step}")


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Newest checkpoint-* dir (auto-resume, train.py:2163-2166)."""
    if not os.path.isdir(output_dir):
        return None
    best = None
    best_step = -1
    for name in os.listdir(output_dir):
        m = re.match(r"^checkpoint-(\d+)$", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(output_dir, name)
    return best


def _encode(tree, path: str, tensors: dict):
    """The payload as JSON, each tensor replaced by {"__tensor__": path}
    and copied to host memory into `tensors`."""
    if isinstance(tree, torch.Tensor):
        tensors[path] = tree.detach().to("cpu", copy=True)
        return {"__tensor__": path}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if not isinstance(k, str) or "/" in k:
                raise ValueError(f"checkpoint key {k!r} under {path!r}: keys "
                                 f"are strings without '/'")
            out[k] = _encode(v, f"{path}/{k}" if path else k, tensors)
        return out
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"checkpoint leaf {path!r} of type {type(tree).__name__}"
                    f": tensors, dicts and JSON scalars only")


def _decode(node, f: SafetensorsFile):
    if isinstance(node, dict):
        if set(node) == {"__tensor__"}:
            return f.get(node["__tensor__"]).clone()
        return {k: _decode(v, f) for k, v in node.items()}
    return node


def _write(path: str, meta, tensors: dict) -> None:
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{next(_TMP_IDS)}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        save_file(tensors, os.path.join(tmp, TENSORS))
        with open(os.path.join(tmp, META), "w") as fh:
            json.dump({"format": _FORMAT, "payload": meta}, fh)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def save_checkpoint(
    output_dir: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    extra: Optional[dict] = None,
    async_save: bool = False,
) -> str:
    """Write {"params", "step", "opt_state"?, "extra"?} to
    `<output_dir>/checkpoint-<step>`; returns its absolute path."""
    global _SAVER
    path = os.path.abspath(_ckpt_dir(output_dir, step))
    payload = {"params": params, "step": step}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if extra:
        payload["extra"] = extra
    tensors: dict = {}
    meta = _encode(payload, "", tensors)
    if async_save:
        if _SAVER is None:
            _SAVER = _AsyncSaver()
        _SAVER.submit(_write, path, meta, tensors)
    else:
        _write(path, meta, tensors)
    return path


def _fit(got, tmpl, path: str):
    """`got` shaped as the template: each tensor on the template leaf's
    device and in its dtype, keys and shapes checked."""
    if isinstance(tmpl, dict):
        if not isinstance(got, dict) or set(got) != set(tmpl):
            have = set(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"checkpoint entry {path or '/'!r}: keys "
                             f"{sorted(set(tmpl) ^ set(have))[:4]} differ "
                             f"from the template's")
        return {k: _fit(got[k], v, f"{path}/{k}") for k, v in tmpl.items()}
    if isinstance(tmpl, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != tmpl.shape:
            raise ValueError(f"checkpoint entry {path!r}: "
                             f"{getattr(got, 'shape', got)} where the "
                             f"template has {tuple(tmpl.shape)}")
        return got.to(device=tmpl.device, dtype=tmpl.dtype)
    return got


def restore_checkpoint(path: str, template: Optional[Any] = None) -> dict:
    """The payload under `path` (CPU tensors), or, with a template, the
    payload checked against it and each tensor moved to the template
    leaf's device and dtype."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, META)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"No structure could be identified for the checkpoint at "
            f"{path}: it has no {META}")
    with open(meta_path) as fh:
        meta = json.load(fh)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{meta_path}: not a checkpoint of this package")
    with SafetensorsFile(os.path.join(path, TENSORS)) as f:
        payload = _decode(meta["payload"], f)
    return payload if template is None else _fit(payload, template, "")


def is_adapter_param(name: str) -> bool:
    return name.startswith("projector.") or name == "image_newline"


def save_adapter_only(output_dir: str, step: int, params: dict) -> str:
    """Projector (+ newline) only save for stage 1 (llava_trainer.py:
    441-463 mm_projector.bin analogue): the `projector.*` and
    `image_newline` entries of the state dict `params`."""
    sub = {k: v for k, v in params.items() if is_adapter_param(k)}
    if "image_newline" not in sub or len(sub) < 2:
        raise KeyError("save_adapter_only: params hold no projector or "
                       "image_newline")
    path = os.path.abspath(os.path.join(_ckpt_dir(output_dir, step),
                                        ADAPTER))
    tensors: dict = {}
    _write(path, _encode(sub, "", tensors), tensors)
    return path


def load_adapter_into(params: dict, adapter_path: str) -> dict:
    """A copy of the state dict `params` with its projector and newline
    replaced by a saved adapter's (builder.py:62-123 base + projector
    load), each on the device of the entry it replaces."""
    sub = restore_checkpoint(adapter_path)
    unknown = sorted(set(sub) - set(params))
    if unknown:
        raise KeyError(f"adapter entries {unknown[:4]} are not in params")
    out = dict(params)
    for k, v in sub.items():
        out[k] = v.to(params[k].device)
    return out
