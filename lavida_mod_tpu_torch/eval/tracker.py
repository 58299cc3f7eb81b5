"""Evaluation result tracking + experiment logging.

Capability counterpart of the reference's result-logging layer
(eval/lmms_eval/loggers/evaluation_tracker.py:101-330 and
wandb_logger.py): date-stamped aggregated-results files with run metadata,
per-sample jsonl logs keyed by task, and an optional wandb sink (the env
has no wandb; the logger degrades to the jsonl files, matching how the
reference behaves with --wandb_args unset).

The port's copy of lavida_mod_tpu/eval/tracker.py (`wandb` imported
inside the functions that use it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Optional


def _sanitize(name: str) -> str:
    return name.replace("/", "__").replace(" ", "_")


def _git_hash() -> Optional[str]:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            stderr=subprocess.DEVNULL, text=True,
        ).strip()
    except Exception:
        return None


@dataclasses.dataclass
class GeneralConfigTracker:
    """Run metadata recorded alongside results
    (evaluation_tracker.py:33-98)."""

    model_source: str = ""
    model_name: str = ""
    system_instruction: Optional[str] = None
    chat_template: Optional[str] = None
    start_time: float = dataclasses.field(default_factory=time.perf_counter)
    end_time: Optional[float] = None
    total_evaluation_time_seconds: Optional[str] = None

    def log_end_time(self):
        self.end_time = time.perf_counter()
        self.total_evaluation_time_seconds = str(
            self.end_time - self.start_time
        )


class EvaluationTracker:
    """Save aggregated results + per-sample logs under
    `<output_dir>/<model_name>/` with UTC-date-stamped filenames
    (evaluation_tracker.py:170-322 layout)."""

    def __init__(self, output_dir: str, model_name: str = "lavida_mod_tpu"):
        self.output_dir = output_dir
        self.model_name = _sanitize(model_name)
        self.general = GeneralConfigTracker(model_name=model_name)
        self._dir = os.path.join(output_dir, self.model_name)
        os.makedirs(self._dir, exist_ok=True)

    def _stamp(self) -> str:
        return time.strftime("%Y-%m-%dT%H-%M-%S", time.gmtime())

    def save_results_aggregated(self, results: dict,
                                samples: Optional[dict] = None) -> str:
        self.general.log_end_time()
        payload = {
            "results": results,
            "config": {
                **dataclasses.asdict(self.general),
                "git_hash": _git_hash(),
            },
            "date": self._stamp(),
        }
        path = os.path.join(self._dir, f"results_{self._stamp()}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        if samples:
            for task, rows in samples.items():
                self.save_results_samples(task, rows)
        return path

    def save_results_samples(self, task_name: str, samples: list) -> str:
        path = os.path.join(
            self._dir, f"samples_{_sanitize(task_name)}_{self._stamp()}.jsonl"
        )
        with open(path, "w") as f:
            for s in samples:
                f.write(json.dumps(s, default=str) + "\n")
        return path


class WandbLogger:
    """wandb sink (reference wandb_logger.py); no-ops gracefully when the
    wandb package is absent (it is not in this environment)."""

    def __init__(self, project: str = "lavida_mod_tpu-eval", **init_kw):
        try:
            import wandb

            self._run = wandb.init(project=project, **init_kw)
        except Exception:
            self._run = None

    @property
    def active(self) -> bool:
        return self._run is not None

    def post_init(self, results: dict):
        if self._run is not None:
            self._run.config.update(results.get("config", {}))

    def log_eval_result(self, results: dict):
        if self._run is not None:
            flat = {
                f"{task}/{metric}": v
                for task, metrics in results.items()
                for metric, v in metrics.items()
                if isinstance(v, (int, float))
            }
            self._run.log(flat)

    def log_eval_samples(self, task: str, samples: list):
        if self._run is not None:
            import wandb

            cols = sorted({k for s in samples for k in s})
            table = wandb.Table(columns=cols)
            for s in samples:
                table.add_data(*[s.get(c) for c in cols])
            self._run.log({f"{task}_samples": table})

    def finish(self):
        if self._run is not None:
            self._run.finish()
