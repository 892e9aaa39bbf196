"""Run logging and the per-epoch metrics recorder."""

from dynamic_load_balance_distributeddnn_tpu_torch.obs.logging import (
    init_logger,
    mark_run_done,
    run_already_done,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs.recorder import (
    SERIES,
    MetricsRecorder,
)

__all__ = [
    "SERIES",
    "MetricsRecorder",
    "init_logger",
    "mark_run_done",
    "run_already_done",
]
