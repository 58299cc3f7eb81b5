"""Logging: the port of lavida_mod_tpu/utils/logging.py.

`rank0_print` prints on the process of rank 0 (every process when
torch.distributed is not initialized).  `MetricsLogger` appends one JSON
row per call to `<output_dir>/metrics.jsonl`, {"step": N, "time": unix
seconds, key: float(value) or str(value), ...} as the JAX package writes
it, and passes the row to wandb when `use_wandb` is set and wandb imports
(imported lazily; when it is absent or its init fails, that is printed and
logging goes on to the file alone).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def rank0_print(*args, **kwargs):
    if _rank() == 0:
        print(*args, **kwargs, flush=True)


class MetricsLogger:
    def __init__(self, output_dir: str, use_wandb: bool = False,
                 project: str = "lavida_mod_tpu",
                 run_name: Optional[str] = None):
        self.path = os.path.join(output_dir, "metrics.jsonl")
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=run_name)
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 -- wandb is optional
                rank0_print(f"[logging] wandb unavailable: {e}")

    def log(self, step: int, metrics: dict):
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb:
            self._wandb.log(row, step=step)

    def close(self):
        self._f.close()
        if self._wandb:
            self._wandb.finish()
