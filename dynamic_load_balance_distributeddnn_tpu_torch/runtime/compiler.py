"""The warm service: step graphs captured ahead of the steps that replay them.

The JAX package's ``runtime/compiler.py`` ``AOTCompileService`` compiles
the executables a run will dispatch ahead of time, so that a DBS
rebalance never pays an XLA compile inside a timed epoch: the warm
universe is submitted before epoch 0, pending jobs drain before each
epoch's wall, and the next rebalance's shapes are compiled speculatively
after it. This port's counterpart of a compile is the capture of a step's
CUDA graph (``train/supersteps.py``: warm-up, then capture on the
executor's side stream under ``CAPTURE_GATE.exclusive()``, 2-4 s for a
DenseNet-121 step on an H100), and this service is its counterpart of the
JAX service: the same name and, where it has a meaning, the same contract.

- ``submit(key, inputs, loaded, body, warmup, speculative=)`` queues one
  key, deduped: a key the service knows (queued, captured or failed), or
  that the executor already holds, is a lookup. Nothing is captured at
  submission.
- ``wait(keys)`` captures the given pending keys (default: all), in
  submission order, on the calling thread, and ``compile_now`` does so for
  one key at once. The engine calls them at its untimed points: before an
  epoch's wall (span ``aot_drain``), after it (span ``speculate``), and at
  the top of an elastic epoch for the plan's keys the service does not
  hold (inside the wall, where the JAX package waits for them too).
- A capture that fails raises ``RuntimeError`` with its key; the key stays
  known and ``failed(key)`` says so. Nothing falls back to an eager step.
- ``has``, ``get`` (the executor's prepared entry), ``failed``,
  ``pending``, ``keys``, ``count_keys``, ``stats``, ``clear`` (the
  engine's re-shards and restores drop the executor's graphs, and with
  them every entry and pending key here) and ``close``.

Two parts of the JAX service have no counterpart here, and their flags are
accepted and do nothing (``config.py``):

- its background pool (``--aot_pool``): a capture cannot run beside other
  work on the card (a cuDNN call of another thread beside a capture failed
  with ``CUDNN_STATUS_INTERNAL_ERROR`` on an H100 and invalidated the
  capture; hence ``CAPTURE_GATE``), so captures run on the engine's thread
  in the untimed gaps the JAX package names;
- its subprocess backend (``--aot_backend process``, ``--aot_workers``,
  ``runtime/compile_worker.py``): a CUDA graph belongs to its process and
  its context, and cannot be made elsewhere. The compile that can leave the
  process, ``nvcc``, already runs as concurrent subprocesses
  (``ops/kernels/runtime.py`` ``build``).

:class:`CaptureTracker` is the counterpart of the JAX ``CompileTracker``:
the foreground captures (``run`` capturing a key it did not hold) since
its last ``take``, the count the engine's recapture sentinel reads.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import StepGraphs


class AOTCompileService:
    """Captures step graphs ahead of time into a trainer's ``StepGraphs``.

    ``tick``: called after every finished capture (the engine passes the
    stall watchdog's heartbeat, as the JAX service does)."""

    def __init__(self, graphs: StepGraphs, tick: Optional[Callable[[], None]] = None):
        self.graphs = graphs
        self._tick = tick
        self._queue: "collections.OrderedDict[Hashable, tuple]" = collections.OrderedDict()
        self._state: Dict[Hashable, str] = {}  # key -> "pending", "captured" or "failed"
        self._speculative: set = set()
        self._stats = {"submitted": 0, "deduped": 0, "captured": 0, "failed": 0,
                       "speculative": 0, "speculative_captured": 0, "capture_s": 0.0}

    # ------------------------------------------------------------ public API

    def submit(self, key: Hashable, inputs, loaded: Sequence[bool], body, warmup,
               speculative: bool = False) -> bool:
        """Queue one capture; True if queued, False if the key was known
        (a lookup). ``inputs`` are the key's slots, filled as
        ``StepGraphs.prepare`` wants them."""
        if key in self._state or self.graphs.has(key):
            self._stats["deduped"] += 1
            return False
        self._state[key] = "pending"
        self._queue[key] = (inputs, tuple(bool(f) for f in loaded), body, warmup)
        self._stats["submitted"] += 1
        if speculative:
            self._speculative.add(key)
            self._stats["speculative"] += 1
        return True

    def compile_now(self, key: Hashable, inputs, loaded: Sequence[bool], body, warmup) -> None:
        """Capture one key at once (queued or not)."""
        self.submit(key, inputs, loaded, body, warmup)
        self.wait([key])

    def wait(self, keys: Optional[Sequence[Hashable]] = None) -> List[Hashable]:
        """Capture the given pending keys (default: every pending key) in
        submission order; returns the keys captured. A key that is not
        pending is skipped; a failed capture raises with its key."""
        todo = list(self._queue) if keys is None else [k for k in keys if k in self._queue]
        done = []
        for key in todo:
            inputs, loaded, body, warmup = self._queue.pop(key)
            spec = key in self._speculative
            t0 = self.graphs.capture_s
            try:
                self.graphs.prepare(key, inputs, loaded, body, warmup, speculative=spec)
            except Exception:
                self._state[key] = "failed"
                self._stats["failed"] += 1
                raise
            finally:
                if self._tick is not None:
                    self._tick()
            self._state[key] = "captured"
            self._stats["captured"] += 1
            self._stats["speculative_captured"] += int(spec)
            self._stats["capture_s"] += self.graphs.capture_s - t0
            done.append(key)
        return done

    def has(self, key: Hashable) -> bool:
        """Key known (pending, captured or failed), or held by the executor."""
        return key in self._state or self.graphs.has(key)

    def get(self, key: Hashable):
        """The executor's prepared entry for a key this service captured,
        or None (unknown, pending or failed)."""
        if self._state.get(key) != "captured":
            return None
        return self.graphs._entries.get(key)

    def failed(self, key: Hashable) -> bool:
        return self._state.get(key) == "failed"

    def pending(self) -> int:
        return len(self._queue)

    def keys(self) -> List[Hashable]:
        return list(self._state)

    def count_keys(self, name_prefixes: Tuple[str, ...]) -> int:
        """Captured keys whose first element (the path) starts with one of
        the given names."""
        return sum(1 for k, st in self._state.items()
                   if st == "captured" and isinstance(k, tuple) and k
                   and isinstance(k[0], str) and k[0].startswith(name_prefixes))

    def stats(self) -> Dict[str, float]:
        """The counters, with ``speculative_hits`` (speculative captures a
        later step replayed), ``speculative_misses`` (speculative captures
        no step has replayed yet: wasted so far) and ``pending``."""
        out = dict(self._stats)
        hits = self.graphs.speculative_hits
        out["speculative_hits"] = hits
        out["speculative_misses"] = out["speculative_captured"] - hits
        out["pending"] = len(self._queue)
        return out

    def clear(self) -> None:
        """Drop every entry and pending key (the executor's graphs were
        dropped: a re-shard, a restore, a new combine)."""
        self._queue.clear()
        self._state.clear()
        self._speculative.clear()

    def close(self) -> None:
        """Drop the pending keys; nothing runs in the background."""
        for key in self._queue:
            self._state.pop(key, None)
        self._queue.clear()


class CaptureTracker:
    """Foreground captures of one executor since the last :meth:`take`:
    the JAX ``CompileTracker``'s role, the count the engine's recapture
    sentinel reads each epoch."""

    def __init__(self, graphs: StepGraphs):
        self.graphs = graphs
        self._last = graphs.foreground_captures

    def take(self) -> int:
        now = self.graphs.foreground_captures
        n, self._last = now - self._last, now
        return n
