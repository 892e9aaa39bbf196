"""graftscope: run-wide span tracing with Perfetto-exportable output (the
JAX package's ``obs/trace.py``, copied).

The DBS feedback loop re-partitions from measurements; this module is the
one artifact that says where an epoch's wall went. The engine wraps each
phase (plan/solve, train, probe, validation, record) in a span; the buffer
exports as Chrome-trace-event JSON loadable in Perfetto or
chrome://tracing, summarizable by ``obs/scope_cli.py``, and can line up
with the card's timeline: ``--trace_annotations`` wraps each span in a
``torch.profiler.record_function`` and an NVTX range, so a
``--profile_dir`` trace shows the host spans beside the kernels (the JAX
package's ``jax.profiler.TraceAnnotation`` bridge).

Design constraints, in order:

* **near-zero cost when disabled** — the tracer ships enabled in no default
  config, so every call site must degrade to one attribute check. A disabled
  ``span()`` returns a shared singleton no-op context manager: no object,
  no dict, no closure is allocated. Call sites therefore pass span
  attributes as an optional ``args`` dict rather than ``**kwargs``.
* **thread-aware** — events record the OS thread id and name at emit time,
  so each thread gets its own named track in Perfetto.
* **bounded when asked** — ``mode="ring"`` keeps the last ``ring_size``
  events in a deque; ``mode="on"`` keeps everything.
* **no wall-clock surprises** — timestamps come from ``time.perf_counter``
  (monotonic), rebased to the tracer's epoch so exported ``ts`` values are
  small; span emission never synchronizes the device and never touches the
  profiler unless the annotation bridge is explicitly enabled.

Event tuples are ``(name, cat, ph, ts_us, dur_us, tid, args)`` with
``ph in ("X", "i", "C")`` — complete spans, instant events, counters.
``args`` additionally carries the tracer's *current epoch* (``set_epoch``)
so offline attribution can group spans per epoch without parsing span
nesting across threads.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from functools import wraps
from typing import Dict, List, Optional, Tuple

_LOG = logging.getLogger("graftscope")

# Phase taxonomy: spans with cat="phase" are the NON-OVERLAPPING controller
# segments that tile an epoch span (cat="epoch"); attribution() sums them.
# Deeper instrumentation uses the other categories so nested spans never
# double-count into the per-phase table.
EPOCH_CAT = "epoch"
PHASE_CAT = "phase"


class _NullSpan:
    """Shared do-nothing context manager for the disabled path. A singleton:
    ``tracer.span(...)`` returns THIS object when tracing is off, so the
    disabled fast path allocates nothing per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records on ``__exit__``. Separate from the tracer so
    spans can nest freely and cross threads (each span captures its own
    thread id at entry)."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        if self._tracer._annotate:
            self._ann = _Annotation(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._emit(self.name, self.cat, "X", self._t0, t1 - self._t0, self.args)
        return False


class _Annotation:
    """A span's mark on the device timeline: a
    ``torch.profiler.record_function`` range (seen by ``--profile_dir``'s
    profiler) and, with a card, an NVTX range."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name: str):
        import torch

        self._rf = torch.profiler.record_function(name)
        self._nvtx = name if torch.cuda.is_available() else None

    def __enter__(self):
        import torch

        self._rf.__enter__()
        if self._nvtx is not None:
            torch.cuda.nvtx.range_push(self._nvtx)
        return self

    def __exit__(self, *exc):
        import torch

        if self._nvtx is not None:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


class Tracer:
    """Span/instant/counter recorder with Chrome-trace export.

    ``mode``: ``"off"`` (every call degrades to the singleton no-op),
    ``"on"`` (unbounded buffer), ``"ring"`` (keep the last ``ring_size``
    events). ``annotations=True`` additionally wraps each span in a
    ``torch.profiler.record_function`` and an NVTX range so host spans line
    up with the card's timeline when a profiler trace (``--profile_dir``)
    is active.
    """

    def __init__(
        self,
        mode: str = "off",
        ring_size: int = 1_000_000,
        annotations: bool = False,
    ):
        self.configure(mode, ring_size=ring_size, annotations=annotations)

    # ------------------------------------------------------------- lifecycle

    def configure(
        self,
        mode: str,
        ring_size: int = 1_000_000,
        annotations: bool = False,
    ) -> "Tracer":
        if mode not in ("off", "on", "ring"):
            raise ValueError(f"trace mode must be 'off', 'on' or 'ring', got {mode!r}")
        # a reconfigure retires any attached flight-recorder spool: the next
        # run must not stream into the previous run's file (the writer
        # drains synchronously, so a clean reconfigure loses nothing)
        old_spool = getattr(self, "_spool", None)
        if old_spool is not None:
            old_spool.close()
        self._spool = None
        self.mode = mode
        # deliberately unlocked: `enabled` is a write-once-per-configure
        # bool read by every span() call on pipeline/compile-pool threads —
        # the DISABLED-mode contract is ONE attribute check with zero
        # allocations, and a momentarily stale read only drops/keeps one
        # span around a reconfigure (configure happens at run boundaries,
        # never under live traffic)
        self.enabled = mode != "off"
        self._annotate = bool(annotations) and self.enabled
        # deque.append is atomic under the GIL — pipeline/compile-pool
        # threads emit without a lock on the hot path
        self._events: deque = deque(maxlen=ring_size if mode == "ring" else None)
        self._epoch_base = time.perf_counter()
        # wall-clock twin of the perf_counter base: perf_counter is not
        # comparable across processes, so cross-process stitching
        # (merge_trace_files) realigns each file's events by the difference
        # of these unix stamps
        self._base_unix = time.time()
        self._current_epoch: Optional[int] = None
        # Per-job tagging (many-stream engine): a thread that calls
        # set_job() gets THREAD-LOCAL job + epoch state, so concurrent job
        # threads stamp their own spans without stomping the global epoch
        # the single-job engine uses. Threads that never set a job tag see
        # the same behavior as before job tags existed (global epoch, no
        # job key). Deliberately unlocked: threading.local() stores every
        # thread's tags in per-thread slots — the "cross-thread" writes
        # never touch shared state — and this rebind happens only at run
        # boundaries (same contract as `enabled` above).
        self._tls = threading.local()
        self._thread_names: Dict[int, str] = {}
        return self

    def reset(self) -> None:
        """Drop buffered events; keep the mode (and any attached spool —
        the spool records the rebase so offline realignment stays exact)."""
        self._events.clear()
        self._epoch_base = time.perf_counter()
        self._base_unix = time.time()
        self._current_epoch = None
        if self._spool is not None:
            self._spool.note_rebase(self._base_unix)

    # --------------------------------------------------- flight recorder

    def attach_spool(self, spool) -> None:
        """Stream every subsequently emitted event into ``spool`` (an
        :class:`~.spool.SpoolWriter`) alongside the in-memory buffer — the
        crash-durable sink. The spool adopts this tracer's ``base_unix``
        (realignment key) and thread-name map. One spool at a time; a
        reconfigure or :meth:`detach_spool` closes it."""
        if self._spool is not None:
            self._spool.close()
        spool._thread_names_src = self._thread_names
        spool._write_meta(self._base_unix)
        self._spool = spool

    def detach_spool(self):
        """Close and detach the spool (drains synchronously). Returns the
        writer (for byte accounting) or None."""
        sp = self._spool
        self._spool = None
        if sp is not None:
            sp.close()
        return sp

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Stamp subsequent events with this epoch index (attribution key).
        The engine sets it at each epoch boundary; None = outside any epoch
        (warm-up, teardown). On a thread carrying a job tag (:meth:`set_job`)
        the epoch is stored thread-locally — concurrent jobs each run their
        own epoch counter without racing on the global."""
        if getattr(self._tls, "job", None) is not None:
            self._tls.epoch = epoch
        else:
            self._current_epoch = epoch

    def set_job(self, job: Optional[str]) -> None:
        """Tag THIS THREAD's subsequently emitted events with a job id
        (many-stream engine: one thread drives one job's epochs). The tag
        and the epoch index both become thread-local for the calling
        thread, so `graftscope summarize --by-job` can attribute wall per
        tenant; ``None`` clears the tag (the thread rejoins the global
        epoch stream)."""
        self._tls.job = job
        if job is None:
            self._tls.epoch = None

    # -------------------------------------------------------------- emitters

    def span(self, name: str, cat: str = PHASE_CAT, args: Optional[dict] = None):
        """Context manager timing one region. Disabled mode returns the
        shared no-op singleton — pass attributes via the ``args`` dict (not
        ``**kwargs``, which would allocate before this check could run)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def traced(self, name: Optional[str] = None, cat: str = PHASE_CAT):
        """Decorator twin of :meth:`span` — times every call of the wrapped
        function under ``name`` (default: the function's __qualname__)."""

        def deco(fn):
            label = name or fn.__qualname__

            @wraps(fn)
            def wrapper(*a, **kw):
                if not self.enabled:
                    return fn(*a, **kw)
                with _Span(self, label, cat, None):
                    return fn(*a, **kw)

            return wrapper

        return deco

    def instant(self, name: str, cat: str = "instant", args: Optional[dict] = None) -> None:
        """Zero-duration marker (watchdog heartbeats, faults, rebalances)."""
        if not self.enabled:
            return
        self._emit(name, cat, "i", time.perf_counter(), 0.0, args)

    def counter(self, name: str, value: float, cat: str = "counter") -> None:
        """Counter sample (compile counts, queue depths) — renders as a
        stacked track in Perfetto."""
        if not self.enabled:
            return
        self._emit(name, cat, "C", time.perf_counter(), 0.0, {"value": float(value)})

    def _emit(self, name, cat, ph, t0: float, dur: float, args) -> None:
        tid = threading.get_ident()
        if tid not in self._thread_names:
            # dict writes are GIL-atomic; a benign race re-writes the same name
            self._thread_names[tid] = threading.current_thread().name
        job = getattr(self._tls, "job", None)
        if job is not None:
            epoch = getattr(self._tls, "epoch", None)
        else:
            epoch = self._current_epoch
        if epoch is not None or job is not None:
            args = dict(args) if args else {}
            if epoch is not None:
                args.setdefault("epoch", epoch)
            if job is not None:
                args.setdefault("job", job)
        rec = (
            name,
            cat,
            ph,
            (t0 - self._epoch_base) * 1e6,  # us, Chrome-trace's unit
            dur * 1e6,
            tid,
            args,
        )
        self._events.append(rec)
        sp = self._spool
        if sp is not None:
            sp.put(rec)

    # --------------------------------------------------------------- export

    def events(self) -> List[Tuple]:
        return list(self._events)

    def event_count(self) -> int:
        """Buffered-event count, O(1): ``len`` on the deque — never copy a
        potentially million-tuple buffer just to measure it (the registry's
        snapshot calls this on every poll)."""
        return len(self._events)

    def chrome_events(self) -> List[dict]:
        """Buffered events as Chrome-trace-event dicts (the ``traceEvents``
        list), plus thread-name metadata so Perfetto labels the tracks.

        Snapshots (``list(...)`` — one C-level call, atomic under the GIL)
        before the Python-level loops: background threads (AOT pool,
        transfer pipeline) may still be emitting, and iterating the live
        deque/dict while they append raises RuntimeError mid-export."""
        pid = os.getpid()
        out: List[dict] = []
        for tid, tname in sorted(list(self._thread_names.items())):
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        for name, cat, ph, ts, dur, tid, args in list(self._events):
            ev = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": round(ts, 3),
                "pid": pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur, 3)
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def save(self, path: str) -> str:
        """Write the buffer as Chrome-trace JSON (open in Perfetto via
        ui.perfetto.dev or chrome://tracing). Returns the path."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        payload = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            # cross-process alignment key (see merge_trace_files); extra
            # top-level keys are legal Chrome-trace metadata
            "graftscope": {"base_unix": self._base_unix},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def summary(self) -> Dict:
        """Per-epoch per-phase attribution of the buffered events (see
        :func:`attribution`)."""
        return attribution(self.chrome_events())


# ---------------------------------------------------------------- attribution


def load_trace(path: str) -> List[dict]:
    """Chrome-trace JSON -> the traceEvents list (accepts both the object
    form this module writes and a bare event array)."""
    return _load_trace_payload(path)[0]


def _load_trace_payload(path: str) -> "Tuple[List[dict], Optional[float]]":
    """(traceEvents, graftscope base_unix or None) from one trace file."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        base = (data.get("graftscope") or {}).get("base_unix")
        return list(data.get("traceEvents", [])), base
    return list(data), None


def merged_names(path: str) -> List[str]:
    """Basenames of worker trace files already stitched into ``path`` (the
    ``graftscope.merged`` marker merge_trace_files writes) — so a second
    stitch pass (the engine merges at save; `graftscope summarize` stitches
    siblings) skips them instead of double-counting their spans."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(data, dict):
        return list((data.get("graftscope") or {}).get("merged", []))
    return []


def merge_trace_events(
    paths: List[str], skipped: Optional[List[str]] = None
) -> List[dict]:
    """Stitch several trace files' events into one pid-tagged stream.

    The first path is the PRIMARY (its timeline is the reference frame);
    each additional file — e.g. the compile workers' per-process span files
    (runtime/compile_worker.py) — contributes its events shifted into the
    primary's clock using the ``graftscope.base_unix`` stamps both files
    carry (perf_counter timelines are per-process; the unix-time twin of the
    tracer base makes them comparable to wall-clock accuracy). Files from
    pids the primary doesn't know get a ``process_name`` metadata event
    derived from their filename, so Perfetto labels the worker tracks.

    A truncated or mid-write EXTRA file (the chaos harness kills processes
    during ``save``) is skipped with a warning and its basename appended to
    ``skipped`` (when a list is passed) — one torn worker file must not
    cost the whole merge. The primary still raises: there is no reference
    frame without it."""
    out: List[dict] = []
    base0: Optional[float] = None
    for i, path in enumerate(paths):
        try:
            events, base = _load_trace_payload(path)
        except (OSError, ValueError) as exc:
            if i == 0:
                raise
            _LOG.warning(
                "graftscope: skipping unreadable trace file %s (%s)",
                path, exc,
            )
            if skipped is not None:
                skipped.append(os.path.basename(path))
            continue
        if i == 0:
            base0 = base
        shift_us = 0.0
        if i > 0 and base is not None and base0 is not None:
            shift_us = (base - base0) * 1e6
        named = {
            e.get("pid")
            for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
        }
        pids = {e.get("pid") for e in events if e.get("pid") is not None}
        label = os.path.basename(path)
        for suffix in (".json", ".trace"):
            if label.endswith(suffix):
                label = label[: -len(suffix)]
        for pid in sorted(p for p in pids - named if p is not None):
            out.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": label if i > 0 else "trainer"},
                }
            )
        for ev in events:
            if shift_us and "ts" in ev:
                ev = dict(ev)
                ev["ts"] = round(ev["ts"] + shift_us, 3)
            out.append(ev)
    return out


def merge_trace_files(
    primary: str, extra_paths: List[str], out_path: Optional[str] = None
) -> str:
    """Merge ``extra_paths`` (compile-worker trace files) into ``primary``
    (in place by default) so one artifact holds the run's host spans AND the
    workers' compile walls as pid-tagged tracks. Returns the written path."""
    out_path = out_path or primary
    extras = [p for p in extra_paths if os.path.exists(p)]
    paths = [primary] + extras
    _, base = _load_trace_payload(primary)
    skipped: List[str] = []
    events = merge_trace_events(paths, skipped=skipped)
    payload = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # record what was stitched so a later pass (summarize auto-stitching
        # siblings) skips these files instead of double-counting; torn files
        # surface in ``skipped`` rather than silently vanishing
        "graftscope": {
            "merged": sorted(
                set(merged_names(primary))
                | ({os.path.basename(p) for p in extras} - set(skipped))
            )
        },
    }
    if skipped:
        payload["graftscope"]["skipped"] = sorted(skipped)
    if base is not None:
        payload["graftscope"]["base_unix"] = base
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, out_path)
    return out_path


def attribution(events: List[dict]) -> Dict:
    """Per-epoch wall attribution from Chrome-trace events.

    Epoch spans (cat=="epoch") define each epoch's wall; phase spans
    (cat=="phase") carrying the same ``args.epoch`` tile it — the
    instrumentation contract keeps phases non-overlapping on the controller
    thread, so their plain sum is the attributed wall. Returns::

        {"epochs": {epoch: {"wall_s", "phases": {name: s}, "coverage"}},
         "phase_totals_s": {name: s},
         "coverage_min": float | None}

    ``coverage`` is attributed/wall per epoch; ``coverage_min`` the worst
    epoch — the quantity the bench's >=0.95 acceptance reads.
    """
    walls: Dict[int, float] = {}
    phases: Dict[int, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        epoch = (ev.get("args") or {}).get("epoch")
        if epoch is None:
            continue
        dur_s = float(ev.get("dur", 0.0)) / 1e6
        if ev.get("cat") == EPOCH_CAT:
            walls[epoch] = walls.get(epoch, 0.0) + dur_s
        elif ev.get("cat") == PHASE_CAT:
            phases.setdefault(epoch, {})
            phases[epoch][ev["name"]] = phases[epoch].get(ev["name"], 0.0) + dur_s
    epochs: Dict[int, Dict] = {}
    totals: Dict[str, float] = {}
    coverage_min: Optional[float] = None
    for epoch in sorted(walls):
        per = phases.get(epoch, {})
        wall = walls[epoch]
        cov = (sum(per.values()) / wall) if wall > 0 else None
        epochs[epoch] = {
            "wall_s": round(wall, 6),
            "phases": {k: round(v, 6) for k, v in sorted(per.items())},
            "coverage": round(cov, 4) if cov is not None else None,
        }
        for k, v in per.items():
            totals[k] = totals.get(k, 0.0) + v
        if cov is not None:
            coverage_min = cov if coverage_min is None else min(coverage_min, cov)
    return {
        "epochs": epochs,
        "phase_totals_s": {k: round(v, 6) for k, v in sorted(totals.items())},
        "coverage_min": round(coverage_min, 4) if coverage_min is not None else None,
    }


def attribution_by_job(events: List[dict]) -> Dict:
    """Per-JOB wall attribution (many-stream engine): epoch spans carrying
    an ``args.job`` tag (set by :meth:`Tracer.set_job` on each job's
    thread) group per tenant instead of per epoch index. Returns::

        {"jobs": {job: {"wall_s", "epochs", "phases": {name: s}}}}

    Untagged spans (a single-job run) land under the ``"-"`` pseudo-job,
    so `graftscope summarize --by-job` degrades gracefully on legacy
    traces."""
    jobs: Dict[str, Dict] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        if args.get("epoch") is None and ev.get("cat") not in (
            EPOCH_CAT, PHASE_CAT,
        ):
            continue
        job = str(args.get("job", "-"))
        dur_s = float(ev.get("dur", 0.0)) / 1e6
        rec = jobs.setdefault(
            job, {"wall_s": 0.0, "epochs": set(), "phases": {}}
        )
        if ev.get("cat") == EPOCH_CAT:
            rec["wall_s"] += dur_s
            if args.get("epoch") is not None:
                rec["epochs"].add(args["epoch"])
        elif ev.get("cat") == PHASE_CAT:
            rec["phases"][ev["name"]] = rec["phases"].get(ev["name"], 0.0) + dur_s
    return {
        "jobs": {
            job: {
                "wall_s": round(rec["wall_s"], 6),
                "epochs": len(rec["epochs"]),
                "phases": {
                    k: round(v, 6) for k, v in sorted(rec["phases"].items())
                },
            }
            for job, rec in sorted(jobs.items())
        }
    }


# -------------------------------------------------------------- global tracer

# One process-wide tracer: the instrumented modules (engine, pipeline, AOT
# service, solver, watchdog) fetch it by function call so a single configure()
# — from config or tests — flips every call site at once. Ships disabled.
_TRACER = Tracer(mode="off")


def get_tracer() -> Tracer:
    return _TRACER


def configure(
    mode: str, ring_size: int = 1_000_000, annotations: bool = False
) -> Tracer:
    """(Re)configure the process-wide tracer; returns it. ``mode="off"``
    restores the zero-cost disabled state (buffer dropped)."""
    return _TRACER.configure(
        mode, ring_size=ring_size, annotations=annotations
    )
