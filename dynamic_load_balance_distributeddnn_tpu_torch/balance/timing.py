"""Per-worker time accounting (the JAX package's ``balance/timing.py``).

The balancer must react to compute speed, not to communication: the
per-worker compute seconds and the injected straggler seconds are kept here,
and the combine+update time is measured separately by the engine and never
enters the solver's vector (PARITY contract 4).
"""

from __future__ import annotations

import numpy as np


class TimeKeeper:
    """Accumulates per-worker compute and injected seconds for one epoch."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.reset()

    def reset(self) -> None:
        self.compute_s = np.zeros(self.world_size, dtype=np.float64)
        self.injected_s = np.zeros(self.world_size, dtype=np.float64)

    def add_compute(self, worker: int, seconds: float) -> None:
        self.compute_s[worker] += seconds

    def add_injected(self, worker: int, seconds: float) -> None:
        """Virtual straggler seconds, counted into the solver's vector."""
        self.injected_s[worker] += seconds


def exchange_times(local_times: np.ndarray) -> np.ndarray:
    """All-gather of per-worker times across processes. This port runs one
    process, so it is the identity."""
    return np.asarray(local_times, dtype=np.float64)
