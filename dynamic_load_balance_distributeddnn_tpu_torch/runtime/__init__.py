"""Host runtime of the port: per-worker health for ``--elastic``
(``runtime/health.py``), the stall watchdog (``runtime/watchdog.py``), the
re-rendezvous of the elastic tier across processes over
``torch.distributed`` (``runtime/rendezvous.py``) and the many-stream
engine, several training jobs multiplexed over the slots of one card
(``runtime/scheduler.py``), the C++ host runtime's bridge: the row
gather of the host-fed path (``runtime/native.py``), and the warm service,
the JAX package's compile service for step graphs: captures made ahead, at
the epoch's untimed points (``runtime/compiler.py``)."""

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
