"""Run logging, the per-epoch metrics recorder, the graftscope tracer and
the metrics registry."""

from dynamic_load_balance_distributeddnn_tpu_torch.obs.logging import (
    init_logger,
    mark_run_done,
    run_already_done,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs.recorder import (
    SERIES,
    MetricsRecorder,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs.registry import MetricsRegistry
from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import (
    EPOCH_CAT,
    Tracer,
    attribution,
    configure as configure_tracer,
    get_tracer,
    load_trace,
)

__all__ = [
    "EPOCH_CAT",
    "SERIES",
    "MetricsRecorder",
    "MetricsRegistry",
    "Tracer",
    "attribution",
    "configure_tracer",
    "get_tracer",
    "init_logger",
    "load_trace",
    "mark_run_done",
    "run_already_done",
]
