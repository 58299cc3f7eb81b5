"""The evaluation layer of the port (lavida_mod_tpu/eval): the task
registry (tasks.py, tasks_ext.py), metrics, filters and IFEval checks, the
evaluator, the tracker, the eval-model adapter, and the CLI
`python -m lavida_mod_tpu_torch.eval`."""

from .evaluator import evaluate, simple_evaluate  # noqa: F401
from .tasks import get_task, list_tasks  # noqa: F401
