"""Host utilities of the training CLI: checkpoints, the metrics log and
profiling (the port of lavida_mod_tpu/utils/)."""

from .checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_adapter_into,
    restore_checkpoint,
    save_adapter_only,
    save_checkpoint,
    wait_for_saves,
)
from .logging import MetricsLogger, rank0_print  # noqa: F401
