"""Crash-durable trace spool: the flight recorder's disk sink (the JAX
package's ``obs/spool.py``, copied; ``--trace_spool``).

graftscope's buffer lives in a process-local deque saved only at end of run
(``Tracer.save``), so the SIGKILL'd and wedged processes the elastic
machinery exists to survive die *with their evidence*. This module streams
the same event tuples to an append-only per-process spool file through a
background flusher thread, so a hard kill loses at most the last flush
interval of events — the victim's timeline survives its process.

File format — length-framed JSONL, built for torn tails:

    <nbytes> <json-body>\n

Each frame is one line: the decimal byte-length of the JSON body, a space,
the body, a newline. A process killed mid-``write`` leaves a final frame
whose body is shorter than its header claims (or a header with no body at
all); the reader detects exactly that and returns every complete frame plus
``truncated=True`` — no record boundary is ever guessed from JSON repair.

Frame bodies:

* ``{"t": "meta", ...}`` — spool identity: pid, logical ident, the tracer's
  ``base_unix`` (the unix-time twin of its ``perf_counter`` base — the same
  cross-process realignment key ``merge_trace_events`` uses), written at
  attach and re-written when the tracer rebases (``Tracer.reset``);
* ``{"t": "ev", "events": [...], "threads": {...}, "dropped": n}`` — a
  batch of raw tracer tuples ``(name, cat, ph, ts_us, dur_us, tid, args)``
  plus any thread names first seen since the previous flush.

Writer contract (the hot-path side):

* ``put()`` is one bounded-deque append — no lock, no serialization, no
  I/O on the emitting thread (``deque.append`` is GIL-atomic; a full queue
  drops the OLDEST buffered events, counted and reported in the next
  frame's ``dropped``);
* the flusher thread wakes every ``flush_interval_s`` OR when the queue
  crosses ``watermark`` events, serializes the drained batch, writes one
  frame, and optionally ``fsync``\\ s (``fsync=True`` trades flush latency
  for power-loss durability; the default survives process death, which is
  the chaos harness's fault model);
* ``close()`` drains synchronously — a clean exit loses nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# queue sentinel: a rebase record carries the tracer's NEW base_unix after
# Tracer.reset() (events before/after it are in different timebases)
_REBASE = "__rebase__"


def _json_default(o):
    """Last-resort serializer: spool frames must never kill the flusher
    thread over an exotic arg value (numpy scalar, Path, ...)."""
    try:
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:  # pragma: no cover - numpy always present here
        pass
    return str(o)


class SpoolWriter:
    """Append-only spool file with a background flusher thread."""

    def __init__(
        self,
        path: str,
        *,
        base_unix: Optional[float] = None,
        ident: Optional[int] = None,
        pid: Optional[int] = None,
        flush_interval_s: float = 0.25,
        watermark: int = 512,
        max_queue: int = 65536,
        fsync: bool = False,
    ):
        if flush_interval_s <= 0:
            raise ValueError("flush_interval_s must be > 0")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self.fsync = bool(fsync)
        self.watermark = int(watermark)
        self._q: deque = deque(maxlen=int(max_queue))
        self._enqueued = 0   # approximate (unlocked int adds) — drop accounting
        self._flushed = 0    # records consumed from the queue (incl. drops)
        self._dropped_pending = 0  # drops awaiting their report frame
        self.bytes_written = 0
        self._f = open(path, "ab")
        self._thread_names_src: Optional[Dict[int, str]] = None
        self._threads_sent: set = set()
        self._io_lock = threading.Lock()  # close() vs flusher file writes
        # one flush at a time: flush()/close() callers vs the flusher thread
        # — drain + frame write must stay atomic or frames interleave and
        # the drop accounting races
        self._flush_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pid = int(pid) if pid is not None else os.getpid()
        self._ident = ident
        self._write_meta(
            base_unix if base_unix is not None else time.time(), ident
        )
        self._flusher = threading.Thread(
            target=self._run,
            args=(float(flush_interval_s),),
            daemon=True,
            name="trace-spool",
        )
        self._flusher.start()

    # ------------------------------------------------------------ hot path

    def put(self, rec: tuple) -> None:
        """Enqueue one tracer event tuple. Never blocks, never touches the
        file. A full queue drops the oldest events.

        Deliberately unlocked (same contract as the tracer's emit path):
        ``deque.append`` is GIL-atomic, and the flusher only ever
        ``popleft``\\ s — the two ends never contend on an element. The
        ``_enqueued`` counter is approximate by design (drop accounting,
        not a ledger); a lost increment under-counts drops by one."""
        self._q.append(rec)
        self._enqueued += 1
        if len(self._q) >= self.watermark:
            self._wake.set()

    def note_rebase(self, base_unix: float) -> None:
        """The tracer rebased (``reset()``): queue a meta frame so events
        after this point realign against the NEW unix stamp."""
        self._q.append((_REBASE, float(base_unix)))
        self._enqueued += 1
        self._wake.set()

    # ----------------------------------------------------------- flushing

    def _run(self, interval_s: float) -> None:
        while not self._stop.is_set():
            self._wake.wait(interval_s)
            # Event.clear is internally locked; the worst race (a set()
            # landing between wait and clear) costs one early wake-up
            self._wake.clear()
            try:
                self._flush_once()
            except Exception:  # noqa: BLE001 — a sick disk must not kill the run
                pass

    def _drain(self) -> List[tuple]:
        out: List[tuple] = []
        q = self._q
        while True:
            try:
                out.append(q.popleft())
            except IndexError:
                return out

    def _new_thread_names(self) -> Dict[str, str]:
        src = self._thread_names_src
        if not src:
            return {}
        fresh = {}
        for tid, name in list(src.items()):
            if tid not in self._threads_sent:
                self._threads_sent.add(tid)
                fresh[str(tid)] = name
        return fresh

    def _write_frame(self, body: Dict) -> None:
        data = json.dumps(body, default=_json_default).encode("utf-8")
        frame = str(len(data)).encode("ascii") + b" " + data + b"\n"
        with self._io_lock:
            if self._f.closed:
                return
            self._f.write(frame)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self.bytes_written += len(frame)

    def _write_meta(self, base_unix: float, ident: Optional[int] = None) -> None:
        meta: Dict = {
            "t": "meta",
            "pid": self._pid,
            "base_unix": float(base_unix),
            "written_unix": time.time(),
        }
        if ident is None:
            ident = self._ident
        if ident is not None:
            meta["ident"] = int(ident)
        self._write_frame(meta)

    def _flush_once(self) -> None:
        with self._flush_lock:
            batch = self._drain()
            if not batch:
                return
            # drop accounting ONCE over the whole drained batch — rebase
            # sentinels count as consumed records, so a reset never reads
            # as a drop: dropped = enqueued - already consumed - this
            # batch - still queued (approximate by design: the counters
            # are unlocked; an under-count loses one drop, never invents
            # one)
            dropped = max(
                self._enqueued - self._flushed - len(batch) - len(self._q), 0
            )
            self._flushed += len(batch) + dropped
            self._dropped_pending += dropped
            # split around rebase sentinels so frame order preserves timebases
            run: List[tuple] = []
            for rec in batch:
                if len(rec) == 2 and rec[0] == _REBASE:
                    self._emit_events(run)
                    run = []
                    self._write_meta(rec[1])
                else:
                    run.append(rec)
            self._emit_events(run)

    def _emit_events(self, events: List[tuple]) -> None:
        if not events:
            return
        body: Dict = {"t": "ev", "events": [list(e) for e in events]}
        threads = self._new_thread_names()
        if threads:
            body["threads"] = threads
        if self._dropped_pending:
            body["dropped"] = int(self._dropped_pending)
            self._dropped_pending = 0  # report each overflow once
        self._write_frame(body)

    def flush(self) -> None:
        """Synchronous drain of everything queued so far."""
        self._flush_once()

    def close(self) -> None:
        """Drain and close. Idempotent; the flusher thread exits."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._wake.set()
        self._flusher.join(timeout=5.0)
        try:
            self._flush_once()
        except Exception:  # noqa: BLE001 — closing a sick spool stays quiet
            pass
        with self._io_lock:
            if not self._f.closed:
                self._f.close()


# ---------------------------------------------------------------- reading


def read_spool(path: str) -> Dict:
    """Parse one spool file, tolerating a torn final record.

    Returns ``{"meta": first-meta-dict-or-None, "segments": [(base_unix,
    [event tuples])...], "threads": {tid: name}, "dropped": n,
    "truncated": bool, "frames": n}``. ``segments`` groups events by the
    meta frame (timebase) preceding them; a file with no rebase has one
    segment. A header or body shorter than the framing claims — the
    SIGKILL-mid-write case — terminates the parse with ``truncated=True``;
    everything before it is returned intact.
    """
    with open(path, "rb") as f:
        data = f.read()
    meta: Optional[Dict] = None
    segments: List[Tuple[Optional[float], List[tuple]]] = []
    cur_base: Optional[float] = None
    cur_events: List[tuple] = []
    threads: Dict[str, str] = {}
    dropped = 0
    frames = 0
    truncated = False
    pos = 0
    n = len(data)
    while pos < n:
        sp = data.find(b" ", pos, pos + 20)
        if sp < 0:
            truncated = True
            break
        try:
            body_len = int(data[pos:sp])
        except ValueError:
            truncated = True
            break
        start, end = sp + 1, sp + 1 + body_len
        if end + 1 > n or data[end:end + 1] != b"\n":
            truncated = True
            break
        try:
            body = json.loads(data[start:end])
        except ValueError:
            truncated = True
            break
        frames += 1
        pos = end + 1
        if body.get("t") == "meta":
            if meta is None:
                meta = body
            if cur_events:
                segments.append((cur_base, cur_events))
                cur_events = []
            cur_base = body.get("base_unix")
        elif body.get("t") == "ev":
            cur_events.extend(tuple(e) for e in body.get("events", ()))
            threads.update(body.get("threads") or {})
            dropped += int(body.get("dropped", 0))
    if cur_events:
        segments.append((cur_base, cur_events))
    return {
        "meta": meta,
        "segments": segments,
        "threads": threads,
        "dropped": dropped,
        "truncated": truncated,
        "frames": frames,
    }


def spool_to_chrome(path: str) -> Dict:
    """One spool file -> Chrome-trace events in ITS OWN timebase, plus the
    realignment key. Returns ``{"events": [...], "base_unix": float|None,
    "pid": int, "ident": int|None, "truncated": bool, "dropped": int}``.

    Multi-segment spools (the tracer rebased mid-run) shift later segments
    into the FIRST segment's timebase using the per-segment unix stamps, so
    one spool always yields one coherent timeline."""
    parsed = read_spool(path)
    meta = parsed["meta"] or {}
    pid = int(meta.get("pid", 0))
    base0: Optional[float] = None
    out: List[dict] = []
    for tid, name in sorted(parsed["threads"].items()):
        out.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": int(tid),
                "args": {"name": name},
            }
        )
    for seg_base, events in parsed["segments"]:
        if base0 is None:
            base0 = seg_base
        shift_us = 0.0
        if seg_base is not None and base0 is not None and seg_base != base0:
            shift_us = (seg_base - base0) * 1e6
        for rec in events:
            try:
                name, cat, ph, ts, dur, tid, args = rec
            except ValueError:
                continue  # malformed row inside an intact frame: skip it
            ev = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": round(float(ts) + shift_us, 3),
                "pid": pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(float(dur), 3)
            if args:
                ev["args"] = args
            out.append(ev)
    return {
        "events": out,
        "base_unix": base0,
        "pid": pid,
        "ident": meta.get("ident"),
        "truncated": parsed["truncated"],
        "dropped": parsed["dropped"],
    }
