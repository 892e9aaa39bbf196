"""Unified metrics registry: one handle over the run's observability
surfaces (the JAX package's ``obs/registry.py``, copied).

The registry binds the :class:`~.recorder.MetricsRecorder` (nine per-epoch
series and extras), the :class:`~..balance.timing.HostOverheadMeter`
(dispatch walls), the tracer, the window controller, the elastic
runtime's per-worker health (``runtime/health.py``) and the many-stream
engine's outer journal (``runtime/scheduler.py``) behind one object the
engine owns:

* ``registry.last(name)`` / ``registry.series(name)`` — recorder access with
  the None-for-absent contract;
* ``registry.snapshot()`` — one JSON-safe dict of everything measurable
  *right now*: recorder last-values, host-meter walls, the card's memory,
  tracer state, the controller's ledgers;
* surfaces registered once (``attach(...)``).

The JAX package also binds its compile counters, a per-engine
``CompileTracker`` and its AOT compile service. This port's counterpart of
a compile is a step graph's capture (``train/supersteps.py``): the
snapshot's ``compiles`` are the process's captures (``total``,
``background``: the warm service's, ``foreground``: those a step made on a
key nobody prepared), the ``compile_tracker`` slot takes the engine's
``runtime/compiler.py`` ``CaptureTracker`` and the ``aot_service`` slot its
``AOTCompileService``, whose ``stats()`` are the snapshot's ``aot``.

The registry holds *references*, not copies — it is a view, never a second
source of truth.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from dynamic_load_balance_distributeddnn_tpu_torch.obs.recorder import MetricsRecorder
from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import Tracer, get_tracer


def device_peak_memory() -> Dict:
    """Per-device memory: with a card, one row per CUDA device with
    ``bytes_in_use`` and ``peak_bytes_in_use`` (``torch.cuda``'s allocator
    statistics); without one, the process's peak RSS (and tracemalloc's
    peak when tracing is active), a coarser host-side ceiling."""
    import torch

    out: Dict = {"source": "memory_stats", "per_device": []}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out["per_device"].append(
                {
                    "device": torch.cuda.get_device_name(i),
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                }
            )
    if not out["per_device"]:
        import resource
        import sys
        import tracemalloc

        out["source"] = "host_rss"
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS
        out["host_peak_rss_bytes"] = int(
            ru if sys.platform == "darwin" else ru * 1024
        )
        if tracemalloc.is_tracing():
            _cur, peak = tracemalloc.get_traced_memory()
            out["tracemalloc_peak_bytes"] = int(peak)
    return out


class MetricsRegistry:
    def __init__(
        self,
        recorder: Optional[MetricsRecorder] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.recorder = recorder if recorder is not None else MetricsRecorder()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.host_meter = None  # balance.timing.HostOverheadMeter
        self.compile_tracker = None  # runtime.compiler.CaptureTracker
        self.aot_service = None  # runtime.compiler.AOTCompileService
        self.controller = None  # balance.controller.OnlineRebalanceController
        self.health = None  # runtime.health.WorkerHealth
        self.scheduler = None  # runtime.scheduler.MultiStreamEngine

    def attach(self, **surfaces) -> "MetricsRegistry":
        """Register observability surfaces by their well-known slot name
        (``host_meter``, ``compile_tracker``, ``aot_service``, ``health``,
        ``controller``, ``scheduler``). Unknown names raise — a typo'd
        attach would silently hollow the snapshot."""
        for name, obj in surfaces.items():
            if name not in ("host_meter", "compile_tracker", "aot_service", "health",
                            "controller", "scheduler"):
                raise ValueError(f"unknown registry surface {name!r}")
            setattr(self, name, obj)
        return self

    # ------------------------------------------------------- recorder facade

    def series(self, name: str) -> List:
        """A recorder series by name ([] for a series never recorded)."""
        return self.recorder.data.get(name, [])

    def last(self, name: str):
        """Last recorded value of a series (None when absent/empty)."""
        return self.recorder.last(name)

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> Dict:
        """JSON-safe point-in-time view across every attached surface."""
        out: Dict = {
            "recorder": {
                k: self.recorder.last(k)
                for k, v in self.recorder.data.items()
                if v
            },
            "trace": {
                "mode": self.tracer.mode,
                # O(1): events() would COPY the whole deque (up to 1M
                # tuples) just to take a length
                "events": self.tracer.event_count() if self.tracer.enabled else 0,
            },
        }
        # gradient-collective wire accounting: the bytes each link class
        # carried in the last epoch (this port's combine is flat, on one card)
        comm = {
            k: self.recorder.last(k)
            for k in ("comm_bytes_ici", "comm_bytes_dcn")
            if self.recorder.last(k) is not None
        }
        if comm:
            comm["grad_comm"] = "flat"
            out["comm"] = comm
        # per-device peak memory: the card's allocator statistics, the
        # host's peak RSS on the CPU
        out["memory"] = device_peak_memory()
        if self.host_meter is not None:
            m = self.host_meter
            out["host"] = {
                "dispatch_s": round(m.dispatch_s, 6),
                "put_s": round(m.put_s, 6),
                "dispatches": m.dispatches,
            }
        # the process's step-graph captures are always available
        from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import capture_counts

        out["compiles"] = capture_counts()
        if self.aot_service is not None:
            out["aot"] = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in self.aot_service.stats().items()
            }
        if self.controller is not None:
            # the online-DBS decision journal's live surface:
            # ledgers, decision count, and the most recent verdict with the
            # inputs it was decided on
            out["controller"] = self.controller.snapshot()
        if self.health is not None:
            out["health"] = self.health.snapshot()
        if self.scheduler is not None:
            # the outer loop's decision journal: the many-stream engine's
            # per-window slot-allocation verdicts in the same journal shape
            # as the inner controller's
            out["scheduler"] = self.scheduler.snapshot()
        return out
