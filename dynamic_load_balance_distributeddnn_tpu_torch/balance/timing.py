"""Per-worker time accounting (the JAX package's ``balance/timing.py``).

The balancer must react to compute speed, not to communication: the
per-worker compute seconds and the injected straggler seconds are kept here,
and the combine+update time is measured separately by the engine and never
enters the solver's vector (PARITY contract 4).

:class:`HostOverheadMeter` keeps the host's own cost of driving an elastic
epoch apart: the seconds spent in launch calls. On the CPU the window
controller subtracts them from a window's measured wall, as the JAX package
does. On the card it reads the windows' time from :class:`DeviceWindowTimer`
instead: there a launch call blocks while the queue is full, so its wall is
device time, and subtracting it left the controller's wall feedback at its
clip floor.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

import numpy as np
import torch


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


class DeviceWindowTimer:
    """The card's own time between the window controller's evaluations.

    ``mark()`` records a timing event at an evaluation boundary on the
    current stream, the one that runs the steps and the graph replays;
    ``seconds()``, called after the device synchronize that follows the
    mark, is the card's time between the last two marks
    (``Event.elapsed_time``). ``active`` is False on the CPU, where there
    are no events and the caller keeps the host clock. ``event_factory``
    replaces ``torch.cuda.Event(enable_timing=True)`` (tests)."""

    def __init__(self, device, event_factory: Optional[Callable] = None):
        if event_factory is None and torch.device(device).type == "cuda":
            event_factory = _timing_event
        self._factory = event_factory
        self._prev = self._last = None

    @property
    def active(self) -> bool:
        return self._factory is not None

    def mark(self) -> None:
        ev = self._factory()
        ev.record()
        self._prev, self._last = self._last, ev

    def seconds(self) -> Optional[float]:
        """Seconds from the previous mark to the last; None before two."""
        if self._prev is None:
            return None
        return self._prev.elapsed_time(self._last) / 1e3


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


class HostOverheadMeter:
    """Per-epoch accounting of the host's cost of driving the card: the
    seconds spent in launch calls (``dispatch()``) and the seconds the
    host-fed path's staging threads spend putting windows on the card
    (``add_put_s``, from ``train/pipeline.py``'s threads, hence the lock).

    ``dispatch()`` wraps the calls that launch a step's work and nothing
    that synchronizes. On the CPU the window controller subtracts it from
    the measured window wall, as the JAX package does; on the card it times
    the windows with :class:`DeviceWindowTimer`. ``put_s`` is the wall of
    each window's stage (its copies enqueued on the copy stream, the slot's
    event recorded), measured on the staging thread while the main thread
    dispatches, so it never enters the dispatch walls; it is 0.0 on an
    epoch whose rows are resident on the card (``--device_cache on``, or
    ``auto`` under the cap), which gathers them there by index."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.dispatch_s = 0.0
            self.put_s = 0.0
            self.dispatches = 0
            self._mark_dispatch_s = 0.0
            self._mark_put_s = 0.0
            self._mark_dispatches = 0

    @contextmanager
    def dispatch(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.dispatch_s += dt
                self.dispatches += 1

    def add_put_s(self, seconds: float) -> None:
        with self._lock:
            self.put_s += float(seconds)

    def mark_window(self) -> "tuple[float, float, int]":
        """``(dispatch_s, put_s, dispatches)`` since the previous mark: the
        host's share of the window controller's wall signal. The epoch
        totals are untouched; a mark only moves the window baseline."""
        with self._lock:
            d = self.dispatch_s - self._mark_dispatch_s
            p = self.put_s - self._mark_put_s
            n = self.dispatches - self._mark_dispatches
            self._mark_dispatch_s = self.dispatch_s
            self._mark_put_s = self.put_s
            self._mark_dispatches = self.dispatches
            return d, p, n

    def per_step(self, num_steps: int) -> float:
        """Host overhead (dispatch + put walls) a plan step."""
        return (self.dispatch_s + self.put_s) / max(int(num_steps), 1)


def exchange_times(local_times: np.ndarray) -> np.ndarray:
    """All-gather of per-worker times across processes (the reference's
    ``time_allreduce`` ring): each process contributes its own workers'
    slice, in float64, and the result is in rank order. One process: the
    identity."""
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import allgather_host

    return allgather_host(np.asarray(local_times, dtype=np.float64))
