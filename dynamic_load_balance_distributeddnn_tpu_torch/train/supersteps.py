"""Supersteps on one card: each training step replayed from a captured CUDA graph.

The JAX package's one-device scan mode (``train/steps.py``
``group_superstep`` / ``group_superstep_idx`` and ``superstep_cache_size``,
``train/engine.py`` ``_elastic_mode`` and ``_dispatch_superstep_window``)
runs a window of elastic steps as ONE compiled ``lax.scan`` that carries the
TrainState: one host dispatch a window, math bit-identical to the per-step
loop. Its packed path scans the whole epoch (``fused_epoch``). Eager
PyTorch launches every kernel of every step from Python instead, and on one
card that host work, not the kernels, sets the wall.

:class:`StepGraphs` is the port's counterpart. It captures **one whole
step** a key into a ``torch.cuda.CUDAGraph`` and replays it once for each
step with that key; the engine runs a window's replays inside one
``HostOverheadMeter.dispatch()``, so ``dispatches`` counts windows as in
the JAX package. A step, not a window, is captured: a replay launches the
same kernels whatever the window, and a window's graph would multiply the
nodes (over 15,000 launches a packed DenseNet-121 step) and the capture
time by the window length to save one host call a step. JAX unrolls its
window only because XLA needs that for bitwise parity.

- **The step** is the engine's body: every worker's forward and backward at
  its true width (with the language model's per-worker clip), the bf16
  casts under ``--precision bfloat16``, the compute-mode load, the sum
  over workers, the SGD-momentum update and the addition of the step's
  loss sum into :attr:`StepGraphs.loss`, a persistent accumulator.
- **The key** holds what the body's launches depend on: the path, each
  worker's batch shape (None for a worker with no real rows that step),
  the compute dtype, ``grad_clip``, which workers carry an injected load,
  and the learning rate. The learning rate is a Python float baked into the
  update's launches: as a tensor it would change the rounding of torch's
  foreach SGD (two roundings in place of ``add(..., alpha=-lr)``).
- **Static slots**: each key owns its input tensors and one device int32
  scalar per injected load (the load kernel reads its count there,
  ``ops/faultload.py``). Before each replay the step's batches, gathered
  and augmented eagerly as before, are copied into them and the counts
  written, so a time-varying straggler schedule needs no new capture.
- **State outside the pool**: the parameters, ``.grad``, the momentum
  buffers (``train/steps.py`` ``prepare_step_state``), the slots and the
  loss accumulator are allocated outside any graph, so only a step's
  temporaries live in graph memory. One pool is then shared by all of a
  trainer's graphs: their replays never overlap.
- **Warm-up** before a capture runs the engine's warm-up (a forward and
  backward a worker without the update, as the probes run them) on the
  capture stream, so cuBLAS, cuDNN and the kernel libraries are loaded and
  have chosen their algorithms; the registered generators' states are
  restored after it and after the capture, so neither changes any training
  state.
- **Random numbers**: the generators given at construction (the trainer's
  dropout generator) are registered with every graph
  (``CUDAGraph.register_generator_state``), so each replay draws what the
  eager step would draw from the same generator state.
- **Launch counts**: the kernel wrappers count in Python, which a replay
  does not run. A capture's counts are taken back (a capture launches
  nothing) and kept a key; each replay adds them (``runtime.LAUNCHES``).
  Warm-up launches are real launches and count as such. The capture reads
  the counts of its capture stream alone (``runtime.LAUNCHES.of``; on
  the CPU, of its thread): the backward's launches, which autograd makes
  from its device thread on that stream, are in them, and launches that
  another tenant makes meanwhile, on its own streams, are neither charged
  to the key nor taken back.
- **Captures and other threads** (the tenants of ``runtime/scheduler.py``,
  each a thread on its own stream): a capture holds ``CAPTURE_GATE``
  exclusively, and a tenant's epoch holds it shared, so a capture runs
  while no other tenant works and no two captures overlap. The gate is
  what isolates a capture: the engine does its own device work (admission,
  re-shards, the final save) between windows, when no epoch runs, so no
  other thread calls into CUDA during a capture and the capture keeps
  PyTorch's default ``global`` error mode. A capture beside another
  tenant's eager work (``thread_local`` mode and a capture lock alone)
  failed on an H100: the other tenant's cuDNN call raised
  ``CUDNN_STATUS_INTERNAL_ERROR`` and the capture was invalidated. The wait for the gate is ``capture_wait_s``,
  outside ``capture_s``.

- **Captures ahead** (``prepare``; the warm service of
  ``runtime/compiler.py`` calls it at the engine's untimed points): a key
  is made from its shapes alone. The engine hands over the slots filled as
  the JAX package's ``_dummy_batch`` fills a warm-up batch (zero inputs,
  label 0, weight ``1 / (b * world_size)``), never ``torch.empty_like``
  memory, whose stray labels would send K2 outside its row; the warm-up and
  the capture are then those of a lazy capture. ``run`` later fills the
  same slots with the real batch before the first replay. Such a capture
  changes no training state: a capture launches nothing, the warm-up
  writes neither the parameters nor ``.grad`` nor the momentum buffers nor
  :attr:`loss` (``prepare_step_state`` only makes a zero ``.grad`` or
  buffer where there is none yet, as a lazy capture's does), and the
  generators' states are put back. ``stats`` keeps
  the captures that ``run`` made on a key it did not hold
  (``foreground_captures``, the ones inside an epoch's wall) apart from the
  service's (``service_captures``), and counts the speculative entries
  that a step later replayed (``speculative_hits``).

A capture or replay that fails raises with its key: nothing falls back to
eager launches. On the CPU, as the tests run it, there are no graphs: the
same executor copies the inputs into the same slots and runs the body
eagerly from them, with each count as an int.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime


class CaptureGate:
    """Step-graph captures against the work of other threads on the card:
    ``shared()`` around a tenant's work (any number at once), ``exclusive()``
    around a capture (alone). A thread that holds it shared sets its hold
    down while it waits for ``exclusive()`` and takes it back after, so
    tenants that capture at once take turns instead of waiting on each
    other; a waiting capture keeps new shared holds out."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._writer = False
        self._waiting = 0
        self._local = threading.local()

    @contextlib.contextmanager
    def shared(self, queue: bool = True):
        """``queue=False``: wait only while a capture runs, not while one
        waits. A staging thread of ``train/pipeline.py`` takes it so: the
        thread it stages for may hold the gate shared and wait on it, and a
        waiting capture that kept it out would then wait on that hold
        forever."""
        with self._cv:
            while self._writer or (queue and self._waiting):
                self._cv.wait()
            self._shared += 1
        self._local.held = getattr(self._local, "held", 0) + 1
        try:
            yield
        finally:
            self._local.held -= 1
            with self._cv:
                self._shared -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        held = getattr(self._local, "held", 0)
        with self._cv:
            self._shared -= held
            self._waiting += 1
            self._cv.notify_all()
            while self._writer or self._shared:
                self._cv.wait()
            self._waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cv:
                self._writer = False
                self._cv.notify_all()
                if held:  # back to the shared hold, after any waiting capture
                    while self._writer or self._waiting:
                        self._cv.wait()
                    self._shared += held


# one process, one card: every StepGraphs captures through this gate
CAPTURE_GATE = CaptureGate()

Inputs = Sequence[Optional[Tuple[torch.Tensor, ...]]]  # a worker's batch, or None
Body = Callable[[List[Optional[Tuple[torch.Tensor, ...]]], list], None]


class CudaStepGraph:
    """One step's ``torch.cuda.CUDAGraph``, captured on the executor's side
    stream into its shared pool, with its generators registered. The
    ``torch.cuda.graph`` context synchronizes and empties the allocator's
    cache before the capture, so the graph's pool can take from the card
    the memory that the run's eager work left cached (without it, a capture
    after the other paths of ``chip_smoke.py`` ran out of memory on an 80 GB
    card with 56 GiB cached and unused). ``StepGraphs`` captures inside
    ``CAPTURE_GATE``, which keeps the other tenants' work off the card
    meanwhile."""

    def __init__(self, stream: torch.cuda.Stream, pool, generators: Sequence[torch.Generator]):
        self.graph = torch.cuda.CUDAGraph()
        self.stream, self.pool = stream, pool
        for g in generators:
            self.graph.register_generator_state(g)

    def capture(self, fn: Callable[[], None]) -> None:
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream):
            fn()

    def replay(self) -> None:
        self.graph.replay()


# process-wide captures, as the JAX package's compile counters are (the
# registry's ``compiles``): every capture, and those the warm service made
_CAPTURES = {"total": 0, "background": 0}
_CAPTURES_LOCK = threading.Lock()


def capture_counts() -> Dict[str, int]:
    """The process's step-graph captures: ``total``, ``background`` (the
    warm service's, ``prepare``) and ``foreground`` (``run``'s)."""
    with _CAPTURES_LOCK:
        total, bg = _CAPTURES["total"], _CAPTURES["background"]
    return {"total": total, "background": bg, "foreground": total - bg}


class _Entry:
    __slots__ = ("inputs", "slots", "graph", "launches", "origin", "used")

    def __init__(self, inputs, slots, origin: str = "run"):
        self.inputs = inputs  # the static input tensors (None for a missing batch)
        self.slots = slots  # per count: its device int32 scalar, or None (no load)
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.origin = origin  # "run", "service" or "speculative"
        self.used = False  # run at least once by ``run``


class StepGraphs:
    """A trainer's step graphs: one captured step a key, replayed a step.

    ``run(key, inputs, counts, body, warmup)`` runs one step: ``inputs``
    are the workers' batches (tuples of tensors, or None), ``counts`` the
    load's iterations for each (0: no load). ``body(inputs, counts)`` is
    the step, ``warmup(inputs, counts)`` its warm-up; both get the key's
    static slots, and on a card each count > 0 as its device scalar (0
    stays 0). ``graph_factory(executor)`` makes a graph object with
    ``capture(fn)`` and ``replay()``; the default is :class:`CudaStepGraph`
    on a CUDA device and none on the CPU, where the body runs eagerly."""

    def __init__(self, device, generators: Sequence[torch.Generator] = (), graph_factory=None,
                 tracer=None):
        self.device = torch.device(device)
        self.tracer = tracer  # each warm-up and capture: a graftscope "warm" span
        self.loss = torch.zeros((), device=self.device)  # the steps' loss sums, added in order
        self.generators = list(generators)
        if graph_factory is None and self.device.type == "cuda":
            graph_factory = _cuda_graph
        self._factory = graph_factory
        self._entries: Dict[Hashable, _Entry] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        self.captures = 0
        self.capture_s = 0.0
        self.capture_wait_s = 0.0  # waiting for CAPTURE_GATE (other tenants' work)
        self.replays = 0  # steps replayed from a graph
        self.eager_runs = 0  # steps run eagerly from the slots (no graphs: the CPU)
        self.foreground_captures = 0  # captured by ``run`` on a key it did not hold
        self.service_captures = 0  # captured ahead by ``prepare``
        self.speculative_hits = 0  # speculative entries a step later ran

    def clear(self) -> None:
        """Drop every captured step (a restore that rewrote the state the
        graphs read must not replay an older capture); the next run of each
        key captures anew."""
        self._entries.clear()

    def superstep_cache_size(self) -> int:
        """Keys with a prepared step (a captured graph on the card, the
        slots alone on the CPU): the quantity the capture-once contract
        bounds by the keys dispatched, as the JAX package's counts its
        compiled superstep variants."""
        return len(self._entries)

    def has(self, key: Hashable) -> bool:
        return key in self._entries

    def stats(self) -> Dict[str, float]:
        return {"captures": self.captures, "capture_s": self.capture_s,
                "capture_wait_s": self.capture_wait_s,
                "replays": self.replays, "eager_runs": self.eager_runs,
                "keys": len(self._entries),
                "foreground_captures": self.foreground_captures,
                "service_captures": self.service_captures,
                "speculative_hits": self.speculative_hits,
                "unused_keys": sum(1 for e in self._entries.values() if not e.used)}

    def prepare(self, key: Hashable, inputs: Inputs, loaded: Sequence[bool], body: Body,
                warmup: Body, speculative: bool = False) -> bool:
        """Capture ``key`` ahead of its first step: ``inputs`` become the
        key's slots as they are (the caller's dummy batches, filled as the
        module docstring says), ``loaded`` says which workers get a count
        slot. On the CPU, without graphs, the slots alone are made. False
        when the key is held already; a failed capture raises with its key
        and leaves no entry."""
        if key in self._entries:
            return False
        slots = [None if b is None else tuple(b) for b in inputs]
        cslots = [torch.zeros((), dtype=torch.int32, device=self.device) if f else None
                  for f in loaded]
        entry = _Entry(slots, cslots, "speculative" if speculative else "service")
        self._entries[key] = entry
        if self._factory is None:
            return True
        try:
            with self._span("warm"):
                self._capture(key, entry, body, warmup)
        except Exception:
            del self._entries[key]
            raise
        self.service_captures += 1
        with _CAPTURES_LOCK:
            _CAPTURES["background"] += 1
        return True

    def run(self, key: Hashable, inputs: Inputs, counts: Sequence[int], body: Body,
            warmup: Body) -> None:
        entry = self._entries.get(key)
        new = entry is None
        if new:
            entry = self._entries[key] = self._new_entry(inputs, counts)
        elif not entry.used and entry.origin == "speculative":
            self.speculative_hits += 1
        entry.used = True
        self._fill(entry, inputs, counts)
        if self._factory is None:
            body(entry.inputs, [int(n) for n in counts])
            self.eager_runs += 1
            return
        if new:
            try:
                with self._span("warm"):
                    self._capture(key, entry, body, warmup)
            except Exception:
                del self._entries[key]  # no half-made entry: the next run captures anew
                raise
            self.foreground_captures += 1
        try:
            entry.graph.replay()
        except Exception as exc:
            raise RuntimeError(f"replaying the step graph of key {key} failed: {exc}") from exc
        for k, d in entry.launches.items():
            runtime.count(k, d, device=self.device)
        self.replays += 1

    # ---------------------------------------------------------------- slots

    def _new_entry(self, inputs: Inputs, counts: Sequence[int]) -> _Entry:
        slots = [None if b is None else tuple(torch.empty_like(t) for t in b) for b in inputs]
        cslots = [torch.zeros((), dtype=torch.int32, device=self.device) if int(n) > 0 else None
                  for n in counts]
        return _Entry(slots, cslots)

    def _fill(self, entry: _Entry, inputs: Inputs, counts: Sequence[int]) -> None:
        for slot, b in zip(entry.inputs, inputs):
            if (slot is None) != (b is None):
                raise ValueError("a step's batches do not match its key's slots")
            if b is not None:
                for dst, src in zip(slot, b):
                    dst.copy_(src)
        for slot, n in zip(entry.slots, counts):
            if slot is not None:
                slot.fill_(int(n))  # a kernel launch with the value: no wait on the card

    # -------------------------------------------------------------- capture

    def side_stream(self) -> torch.cuda.Stream:
        """The stream every warm-up and capture runs on (one for all keys,
        so the shared pool's blocks stay on one stream)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _capture(self, key: Hashable, entry: _Entry, body: Body, warmup: Body) -> None:
        t0 = time.perf_counter()
        counts = [0 if s is None else s for s in entry.slots]
        states = [g.get_state() for g in self.generators]
        try:
            self._warm_up(warmup, entry.inputs, counts)
            self._set_states(states)
            t_gate = time.perf_counter()
            with CAPTURE_GATE.exclusive(), self._span("capture"):
                waited = time.perf_counter() - t_gate
                graph = self._factory(self)
                ctx = self._count_context()
                before = runtime.LAUNCHES.of(ctx)
                graph.capture(lambda: body(entry.inputs, counts))
                after = runtime.LAUNCHES.of(ctx)
        except Exception as exc:
            raise RuntimeError(f"capturing the step graph of key {key} failed: {exc}") from exc
        self._set_states(states)  # the replays draw from where the eager step would
        # a capture records launches and runs none: its counts move to the replays
        entry.launches = {k: v - before[k] for k, v in after.items() if v != before[k]}
        for k, d in entry.launches.items():
            runtime.LAUNCHES.add(ctx, k, -d)
        entry.graph = graph
        self.captures += 1
        with _CAPTURES_LOCK:
            _CAPTURES["total"] += 1
        self.capture_s += time.perf_counter() - t0 - waited
        self.capture_wait_s += waited

    def _span(self, name: str):
        """A graftscope span (cat ``warm``) when the executor has a tracer:
        ``warm`` over a key's warm-up and capture, ``capture`` over the
        capture alone, inside the gate."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, cat="warm")

    def _count_context(self):
        """Where a capture's launches are counted: its capture stream on a
        card, the calling thread on the CPU (a graph factory in tests)."""
        if self.device.type == "cuda":
            return ("stream", self.side_stream().cuda_stream)
        return runtime.context()

    def _warm_up(self, warmup: Body, inputs, counts) -> None:
        if self.device.type == "cuda":
            side, cur = self.side_stream(), torch.cuda.current_stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                warmup(inputs, counts)
            cur.wait_stream(side)
        else:
            warmup(inputs, counts)

    def _set_states(self, states) -> None:
        for g, s in zip(self.generators, states):
            g.set_state(s)


def _cuda_graph(executor: StepGraphs) -> CudaStepGraph:
    return CudaStepGraph(executor.side_stream(), executor._pool, executor.generators)
