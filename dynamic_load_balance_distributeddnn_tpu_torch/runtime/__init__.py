"""Host runtime of the port: per-worker health for ``--elastic``
(``runtime/health.py``). The JAX package's watchdog, rendezvous, scheduler,
native host runtime and compile service are not ported yet (ROADMAP.md)."""

from dynamic_load_balance_distributeddnn_tpu_torch.runtime.health import (
    ALIVE,
    LOST,
    RECOVERING,
    SUSPECT,
    ProcessHeartbeat,
    WorkerHealth,
    WorkerLost,
    retry_transient,
)

__all__ = [
    "ALIVE",
    "LOST",
    "RECOVERING",
    "SUSPECT",
    "ProcessHeartbeat",
    "WorkerHealth",
    "WorkerLost",
    "retry_transient",
]
