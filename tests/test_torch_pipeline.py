"""The host-fed path's transfer pipeline (``train/pipeline.py``) against the
JAX package's ``WindowTransferPipeline``, and its staging slots on the CPU.

The pipeline's contract, as the JAX package states it: windows come back
in order; at most two windows are gathered ahead of the consumer (the
window being read and the next); ``next_unlaunched`` is the first window
whose gather has not started, and ``prefetch`` starts one without
blocking; ``close`` drains the threads; the stages' walls reach the meter's
``put_s``; an exception in ``gather`` surfaces from ``get``. On the same
callbacks the port's pipeline submits the same tasks to its pool, in the
same order, as the JAX package's, and makes the same calls.

``WindowStager`` on the CPU: window ``i`` writes into slot ``i % 2``, a
slot grows when a window outgrows it and is reused otherwise, and a staged
window is a copy, so that the slot's next window does not change it. The
card's side (pinned slots, the copy stream, the events) is held by
``chip_smoke.py`` [4l] and ``tests/test_torch_cuda.py``.
"""

import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.train.pipeline import (
    WindowTransferPipeline as JaxPipeline,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance.timing import HostOverheadMeter
from dynamic_load_balance_distributeddnn_tpu_torch.train.pipeline import (
    StagedWindow,
    WindowStager,
    WindowTransferPipeline,
)

RANGES = [(0, 2), (2, 4), (4, 6), (6, 8), (8, 9)]


class Recorder:
    """Callbacks that log each call (under a lock: they run on the pool)."""

    def __init__(self, delay: float = 0.0, fail_at=None):
        self.calls, self.delay, self.fail_at = [], delay, fail_at
        self.lock = threading.Lock()

    def gather(self, s0, s1):
        time.sleep(self.delay)
        if (s0, s1) == self.fail_at:
            raise RuntimeError(f"gather {s0}:{s1} failed")
        with self.lock:
            self.calls.append(("gather", s0, s1))
        return list(range(s0, s1))

    def stage(self, d, i, data):
        with self.lock:
            self.calls.append(("stage", d, i))
        return ("staged", i, tuple(data))

    def kinds(self, kind):
        return [c for c in self.calls if c[0] == kind]


def _drive(cls, rec, prefetch=True):
    meter = HostOverheadMeter()
    out = []
    with cls(RANGES, rec.gather, rec.stage, [0], meter=meter) as pipe:
        if prefetch:
            pipe.prefetch(0)
        for i in range(len(RANGES)):
            out.append(pipe.get(i))
    return out, meter


@pytest.mark.parametrize("prefetch", [True, False])
def test_windows_come_in_order_with_their_data(prefetch):
    out, meter = _drive(WindowTransferPipeline, Recorder(), prefetch)
    for i, (data, staged) in enumerate(out):
        s0, s1 = RANGES[i]
        assert data == list(range(s0, s1))
        assert staged == {0: ("staged", i, tuple(range(s0, s1)))}
    assert meter.put_s > 0.0 and meter.dispatch_s == 0.0


@pytest.mark.parametrize("prefetch", [True, False])
def test_the_calls_equal_the_jax_pipelines(prefetch, monkeypatch):
    """The same tasks submitted to the pool in the same order, the same
    calls made and the same results. The order in which the pool's two
    threads then run them is the scheduler's (a stage can record before
    the previous window's, in either package), so the executed calls are
    held as a multiset, each window's gather before its stage."""
    submitted = []
    submit = concurrent.futures.ThreadPoolExecutor.submit

    def logged(self, fn, *args, **kw):
        submitted.append((fn.__name__,) + tuple(a for a in args if isinstance(a, int)))
        return submit(self, fn, *args, **kw)

    monkeypatch.setattr(concurrent.futures.ThreadPoolExecutor, "submit", logged)
    a, b = Recorder(), Recorder()
    out_port = _drive(WindowTransferPipeline, a, prefetch)[0]
    port_submitted, submitted[:] = list(submitted), []
    out_jax = _drive(JaxPipeline, b, prefetch)[0]
    assert out_port == out_jax
    assert port_submitted == submitted and len(submitted) == 2 * len(RANGES)
    assert sorted(a.calls) == sorted(b.calls)
    for rec in (a, b):
        for i, (s0, s1) in enumerate(RANGES):
            assert rec.calls.index(("gather", s0, s1)) < rec.calls.index(("stage", 0, i))


def test_at_most_two_windows_are_in_flight():
    rec = Recorder()
    with WindowTransferPipeline(RANGES, rec.gather, rec.stage, [0]) as pipe:
        for i in range(len(RANGES)):
            pipe.get(i)
            time.sleep(0.02)  # the pool could run ahead here, if it were let
            assert len(rec.kinds("gather")) <= min(i + 2, len(RANGES))
            assert pipe.next_unlaunched() == min(i + 2, len(RANGES))


def test_next_unlaunched_and_prefetch():
    rec = Recorder()
    with WindowTransferPipeline(RANGES, rec.gather, rec.stage, [0]) as pipe:
        assert pipe.next_unlaunched() == 0
        pipe.prefetch(0)
        assert pipe.next_unlaunched() == 1
        pipe.prefetch(0)  # already in flight: nothing new
        pipe.prefetch(99)  # past the end: nothing
        assert pipe.next_unlaunched() == 1
        pipe.get(0)
        assert pipe.next_unlaunched() == 2  # window 1 launched before blocking
        pipe.get(1)
        assert pipe.next_unlaunched() == 3
    assert len(rec.kinds("gather")) == 3


def test_close_drains_the_threads():
    rec = Recorder(delay=0.05)
    pipe = WindowTransferPipeline(RANGES, rec.gather, rec.stage, [0])
    pipe.prefetch(0)
    pipe.prefetch(1)
    pipe.close()  # joins both windows' gathers and stages
    assert len(rec.kinds("gather")) == 2 and len(rec.kinds("stage")) == 2
    pipe.close()  # idempotent


def test_a_gather_error_surfaces_from_get():
    rec = Recorder(fail_at=RANGES[2])
    with pytest.raises(RuntimeError, match="gather 4:6 failed"):
        with WindowTransferPipeline(RANGES, rec.gather, rec.stage, [0]) as pipe:
            pipe.get(0)
            pipe.get(1)  # launches window 2, whose gather raises
            pipe.get(2)  # launches window 3, then raises window 2's error
    assert ("stage", 0, 2) not in rec.calls and ("stage", 0, 1) in rec.calls


def test_get_makes_a_staged_window_ready():
    seen = []

    class Probe(StagedWindow):
        def consume(self):
            seen.append(self.meta)

    def stage(d, i, data):
        return Probe((torch.zeros(1),), None, i)

    with WindowTransferPipeline(RANGES, lambda s0, s1: None, stage, [0]) as pipe:
        for i in range(len(RANGES)):
            pipe.get(i)
    assert seen == list(range(len(RANGES)))


def test_stager_slots_alternate_grow_and_copy():
    st = WindowStager("cpu")
    a = st.host(0, "x", (4, 3), torch.uint8)
    b = st.host(1, "x", (4, 3), torch.uint8)
    assert a.data_ptr() != b.data_ptr() and not a.is_pinned()
    a.copy_(torch.arange(12, dtype=torch.uint8).view(4, 3))
    w0 = st.stage(0, (a,), meta="m0")
    assert w0.event is None and w0.meta == "m0"
    assert w0.tensors[0].data_ptr() != a.data_ptr()  # a copy, not the slot
    again = st.host(2, "x", (2, 3), torch.uint8)  # slot 0, reused
    assert again.data_ptr() == a.data_ptr()
    again.fill_(255)
    assert torch.equal(w0.tensors[0], torch.arange(12, dtype=torch.uint8).view(4, 3))
    grown = st.host(4, "x", (9, 3), torch.uint8)  # slot 0, too small: grown
    assert grown.shape == (9, 3) and grown.is_contiguous()
    assert st.host(3, "y", (5,), torch.int64).dtype == torch.int64
    empty = st.host(5, "w", (0,), torch.float32)
    assert empty.shape == (0,) and st.stage(5, (empty,)).tensors[0].shape == (0,)
    w0.consume()  # nothing to wait for on the CPU


def test_stager_packs_a_window_with_take_rows():
    from dynamic_load_balance_distributeddnn_tpu_torch.runtime.native import take_rows

    rng = np.random.RandomState(0)
    data = rng.randint(0, 255, size=(50, 6, 6, 3)).astype(np.uint8)
    st = WindowStager("cpu")
    for i in range(4):
        sel = rng.randint(0, 50, size=7 + 3 * i)
        x = st.host(i, "x", (len(sel), 6, 6, 3), torch.uint8)
        take_rows(data, sel, out=x.numpy())
        staged = st.stage(i, (x,))
        assert np.array_equal(staged.tensors[0].numpy(), data[sel])


def test_a_staging_thread_joins_the_gate_beside_a_waiting_capture():
    """A tenant holds the gate shared for its epoch and waits on its staging
    thread; another tenant's capture waits for that hold. The staging
    thread (``queue=False``) must still enter, or the three would wait on
    each other forever; the capture runs once the tenant lets go."""
    from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import CaptureGate

    gate, log = CaptureGate(), []
    tenant_holds, staged, release = threading.Event(), threading.Event(), threading.Event()

    def until(cond):
        deadline = time.monotonic() + 10
        while not cond():
            assert time.monotonic() < deadline
            time.sleep(0.001)

    def tenant():
        with gate.shared():
            tenant_holds.set()
            until(lambda: gate._waiting == 1)  # the capture is queued on this hold

            def stage():
                with gate.shared(queue=False):
                    log.append("stage")

            t = threading.Thread(target=stage)
            t.start()
            t.join(10)
            staged.set()
            release.wait(10)

    def capture():
        tenant_holds.wait(10)
        with gate.exclusive():
            log.append("capture")

    threads = [threading.Thread(target=tenant), threading.Thread(target=capture)]
    for t in threads:
        t.start()
    assert staged.wait(10) and log == ["stage"]  # entered beside the queued capture
    release.set()
    for t in threads:
        t.join(10)
    assert log == ["stage", "capture"]
