"""Stall watchdog for device-blocking host loops (the JAX package's
``runtime/watchdog.py``, copied).

A rank of this port can block where no Python signal handler runs: inside a
gloo or NCCL collective whose peer froze (a SIGSTOPped process keeps its
sockets open, so the collective waits out the process group's timeout), or
inside a ``torch.cuda.synchronize`` behind a kernel that never ends. The
process then sits idle until an outer timeout fires and burns the whole
budget. The JAX package guards a hang inside PJRT's C++ the same way.

Mechanism: host-side loops call :func:`heartbeat` whenever control returns
from the device or a collective (one step dispatched, one epoch recorded, one
rendezvous poll). :func:`arm_stall_watchdog` starts a daemon thread that
hard-exits the process (``os._exit``, the only reliable abort for a process
blocked in C++) when the heartbeat file goes stale, turning a silent hang
into a bounded, retryable subprocess failure.

Opt-in: nothing is armed unless a caller arms it, and ``heartbeat()`` is a
no-op unless ``DBS_HEARTBEAT_FILE`` is set (one getenv + utime when active).
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time

from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer

_ENV = "DBS_HEARTBEAT_FILE"
_EXIT_TAG = "DBS_WATCHDOG_EXIT "

# Extra files the abort path tags alongside its own heartbeat file — the
# per-process PEER beacon (runtime/health.py) registers here, so a watchdog
# abort is readable by the peers scanning DBS_PEER_HB_DIR, not just by the
# parent watching this process's own heartbeat file.
_EXTRA_TAG_PATHS: set = set()


def register_exit_tag_path(path: str) -> None:
    """Tag ``path`` too when the stall watchdog aborts this process."""
    _EXTRA_TAG_PATHS.add(path)


def unregister_exit_tag_path(path: str) -> None:
    """Drop a registered tag path (the owning run ended: its beacon file
    must not be rewritten by a later run's abort)."""
    _EXTRA_TAG_PATHS.discard(path)


def tag_exit_all(hb_path: str, reason: str) -> None:
    """Tag the watchdog's own heartbeat file AND every registered peer
    beacon file with the abort reason. Last-breath code: a concurrent
    register/unregister (a finalizer on another thread) must not raise out
    of the watchdog thread — that would leave the wedged process it exists
    to abort hanging forever."""
    try:
        paths = {hb_path} | set(tuple(_EXTRA_TAG_PATHS))
    except RuntimeError:  # set mutated mid-copy: settle for our own file
        paths = {hb_path}
    for p in paths:
        tag_exit_reason(p, reason)


def tag_exit_reason(hb_path: str, reason: str) -> None:
    """Write the abort reason INTO the heartbeat file, so the parent (bench
    retry loop, multi-host peer scanning the heartbeat dir) can tell a
    watchdog abort apart from a silent freeze or an OOM kill. The tag
    replaces the file's (empty) pulse content; the mtime pulse semantics are
    moot once the process is about to ``os._exit``."""
    try:
        with open(hb_path, "w") as f:
            f.write(f"{_EXIT_TAG}{reason}\n")
    except OSError:
        pass


def read_exit_reason(hb_path: str):
    """The exit-reason tag a watchdog left in ``hb_path``, or None (absent
    file, unreadable file, or a plain pulse file with no tag)."""
    try:
        with open(hb_path) as f:
            head = f.read(4096)
    except OSError:
        return None
    if head.startswith(_EXIT_TAG):
        return head[len(_EXIT_TAG):].strip()
    return None


def _dump_all_stacks(reason: str) -> None:
    """Post-mortem for the C++-blocked hang: Python-level stacks of every
    thread, via faulthandler (safe to call with the GIL held by *this*
    thread while another is wedged in a collective or a synchronize).
    Lands on stderr, which the run log / parent subprocess captures — the
    only diagnosable record of WHERE the process was stuck, since
    ``os._exit`` skips every destructor and atexit hook."""
    try:
        sys.stderr.write(f"[watchdog] {reason}; all-thread stacks:\n")
        sys.stderr.flush()
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
    except Exception:  # noqa: BLE001 — last-breath diagnostics must not mask the exit
        pass


def heartbeat() -> None:
    """Touch the heartbeat file, if one is configured. With graftscope
    tracing on, each heartbeat additionally lands as an instant event in the
    trace — the device-answered pulse train, visible between spans."""
    tracer = get_tracer()
    if tracer.enabled:
        tracer.instant("heartbeat", cat="heartbeat")
    path = os.environ.get(_ENV)
    if not path:
        return
    try:
        os.utime(path, None)
    except OSError:
        try:
            with open(path, "a"):
                pass
        except OSError:
            pass


def arm_stall_watchdog(
    hb_path: str,
    stall_s: float,
    extra_paths: tuple = (),
    exit_code: int = 19,
    poll_s: float = 15.0,
    first_grace_s: float | None = None,
) -> threading.Thread:
    """Arm a daemon thread that ``os._exit(exit_code)``s this process when
    ``hb_path`` (and every path in ``extra_paths``) has not been touched for
    ``stall_s`` seconds. Sets ``DBS_HEARTBEAT_FILE`` so in-process
    :func:`heartbeat` calls (and those of any child sharing the env) land on
    ``hb_path``. Returns the thread (daemon; dies with the process).

    ``first_grace_s``: stall threshold applied until the FIRST heartbeat
    lands after arming. Heartbeats fire when control returns from the
    device, and the very first unit of work includes the cold build of the
    CUDA kernels (``nvcc``) and the first step graphs' capture, which can
    legitimately exceed ``stall_s``: a build killed half-way is paid again
    on every retry, so a build slower than ``stall_s`` would dead-loop
    every retry. Default:
    ``DBS_WATCHDOG_FIRST_GRACE_S`` env, else 1800s, floored at ``stall_s``.
    Once any heartbeat arrives the tight ``stall_s`` applies."""
    os.environ[_ENV] = hb_path
    if first_grace_s is None:
        first_grace_s = float(os.environ.get("DBS_WATCHDOG_FIRST_GRACE_S", 1800))
    first_grace_s = max(float(first_grace_s), float(stall_s))
    armed_at = time.time()
    hb_baseline: float | None = None
    try:
        parent = os.path.dirname(hb_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(hb_path, "a"):
            pass
        # backdate the arm-time touch so a real heartbeat strictly advances
        # the mtime even on filesystems with coarse (1-2s) granularity;
        # staleness itself is governed by max(armed_at, mtimes), which the
        # backdating cannot lower
        os.utime(hb_path, (armed_at - 10.0, armed_at - 10.0))
        hb_baseline = os.path.getmtime(hb_path)
    except OSError:
        pass

    def _newest_mtime() -> float:
        # fall back to the arm timestamp so the watchdog fails CLOSED even if
        # no watched path could be created (it must still catch a hang that
        # starts before the first heartbeat lands)
        newest = armed_at
        for p in (hb_path, *extra_paths):
            try:
                newest = max(newest, os.path.getmtime(p))
            except OSError:
                pass
        return newest

    def _watch() -> None:
        # cold-start grace: until the heartbeat file itself has been touched
        # after arming (i.e. the device has answered once), allow the longer
        # first_grace_s — the first unit of work carries the cold build,
        # which is slow but healthy. Keyed to hb_path's mtime advancing past
        # the arm-time touch: extra_paths get administrative writes (e.g.
        # the bench's initial incremental-result dump) before any device
        # work, which must not end the grace. If the hb file could not be
        # created at all, heartbeats can never land, so the grace could
        # never end — skip it entirely (fail closed at the tight stall_s).
        grace_active = hb_baseline is not None
        while True:
            time.sleep(poll_s)
            if grace_active:
                try:
                    if os.path.getmtime(hb_path) > hb_baseline:
                        grace_active = False
                except OSError:
                    pass
            last = _newest_mtime()
            threshold = first_grace_s if grace_active else stall_s
            if time.time() - last > threshold:
                reason = (
                    f"stall: no heartbeat for {threshold:.0f}s "
                    "(collective or device hang?)"
                )
                # post-mortem first (stderr -> run log), then the tag the
                # parent reads, then the only reliable abort for a
                # C++-blocked process
                _dump_all_stacks(reason)
                tag_exit_all(hb_path, f"{reason}; exit_code={exit_code}")
                sys.stderr.write(f"[watchdog] {reason}; aborting\n")
                sys.stderr.flush()
                os._exit(exit_code)

    t = threading.Thread(target=_watch, daemon=True, name="stall-watchdog")
    t.start()
    return t
