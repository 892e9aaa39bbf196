"""The host-fed path's double-buffered window pipeline (the JAX package's
``train/pipeline.py``), with its stage on a CUDA copy stream.

Under ``--device_cache off`` (or ``auto`` over ``device_cache_mb``) the
training set stays on the host and the packed and elastic epochs are fed a
window at a time. Each window flows through two stages on a thread pool:

1. **gather**: one task a window packs its rows on the host
   (``runtime/native.py`` ``take_rows``, the multithreaded C++ gather)
   straight into a pinned staging slot (:class:`WindowStager`);
2. **stage**: one task a device (one process owns one device, so one
   task) puts the window on the card as soon as the gather lands, while the
   main thread dispatches the window before it.

``get(i)`` blocks only on window i's staged tensors and launches window
i + 1 first, so steady state keeps exactly two windows in flight. The
stages' walls go to the :class:`HostOverheadMeter` as ``put_s`` from the
staging thread, so the engine's dispatch walls never include them.

**On the card** (:class:`WindowStager`): a window's gather writes into one
of two pinned host slots (window i uses slot ``i % 2``) after waiting for
that slot's previous copy to end (one CUDA event a slot: a
``non_blocking`` copy returns before it ends, and a slot reused early would
corrupt the window it still feeds). The stage allocates the device tensors
on the trainer's dedicated copy stream, enqueues the copies there with
``non_blocking=True`` and records the slot's event. ``get(i)`` makes the
consuming stream (the one current on the calling thread: the default
stream, or a tenant's own) wait on that event and marks every staged tensor
as used there (``record_stream``), so the caching allocator does not hand
its memory out again while the consumer still reads it. Every CUDA call of
the gather and stage threads (pinned allocation, the event wait, the
copies) holds ``train/supersteps.py``'s ``CAPTURE_GATE`` shared: a step
graph's capture on the main thread takes it alone, so no staging thread
calls into CUDA while a capture runs. A staging thread waits only while a
capture runs (``queue=False``), not while one waits: a tenant of
``runtime/scheduler.py`` holds the gate shared for its epoch and waits on
its own staging thread, so another tenant's waiting capture must not keep
that thread out. On the CPU (the tests) the same code
runs without pinning, streams or events: the stage's copy is synchronous.
"""

from __future__ import annotations

import concurrent.futures
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer
from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import CAPTURE_GATE


class WindowTransferPipeline:
    """Double-buffered (gather, then a put a device) pipeline over step
    windows, the JAX package's class with its interface.

    ``ranges``: the epoch's ``(s0, s1)`` windows, in execution order.
    ``gather``: ``gather(s0, s1) -> data``, the host materialization.
    ``stage``: ``stage(device_index, window_index, data) -> staged`` puts
    one window on one device and returns what the consumer reads; a
    :class:`StagedWindow` is made ready on the consuming stream by ``get``.
    ``device_indices``: the devices ``stage`` is fanned out over (``[0]``:
    one process owns one device).
    """

    def __init__(
        self,
        ranges: Sequence[Tuple[int, int]],
        gather: Callable,
        stage: Callable,
        device_indices: Sequence[int],
        meter=None,
    ):
        self._ranges = list(ranges)
        self._gather = gather
        self._stage = stage
        self._devices = list(device_indices)
        self._meter = meter
        # one slot a device's puts, one for the gather of the next window
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(self._devices) + 1)
        self._inflight: Dict[int, Tuple] = {}
        self._launched_through = 0  # windows [0, N) whose gather/puts started

    def next_unlaunched(self) -> int:
        """The first window whose gather has NOT been kicked yet: the
        earliest window a mid-epoch plan switch may re-slice. Windows
        already gathered or staged under the old plan are immutable, so the
        window controller re-plans only from this index on; the gather sees
        the switch through the engine's segment table."""
        return self._launched_through

    def _stage_device(self, d: int, i: int, gather_fut) -> object:
        data = gather_fut.result()
        t0 = time.perf_counter()
        with get_tracer().span("stage", cat="transfer", args={"window": i, "device": d}):
            staged = self._stage(d, i, data)
        if self._meter is not None:
            self._meter.add_put_s(time.perf_counter() - t0)
        return staged

    def _gather_window(self, i: int):
        with get_tracer().span("gather", cat="transfer", args={"window": i}):
            return self._gather(*self._ranges[i])

    def _launch(self, i: int) -> None:
        if i in self._inflight or not (0 <= i < len(self._ranges)):
            return
        gather_fut = self._pool.submit(self._gather_window, i)
        put_futs = {d: self._pool.submit(self._stage_device, d, i, gather_fut)
                    for d in self._devices}
        self._inflight[i] = (gather_fut, put_futs)
        self._launched_through = max(self._launched_through, i + 1)

    def prefetch(self, i: int) -> None:
        """Kick window i's gather and puts without blocking on them."""
        self._launch(i)

    def get(self, i: int) -> Tuple[object, Dict[int, object]]:
        """Window i's ``(host_data, {device_index: staged})``; launches
        window i + 1 before blocking, so that its gather and puts overlap
        window i's execution. A staged window is made ready on the calling
        thread's current stream (:meth:`StagedWindow.consume`)."""
        self._launch(i)
        self._launch(i + 1)
        gather_fut, put_futs = self._inflight.pop(i)
        staged = {d: f.result() for d, f in put_futs.items()}
        for v in staged.values():
            if isinstance(v, StagedWindow):
                v.consume()
        return gather_fut.result(), staged

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "WindowTransferPipeline":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None


class StagedWindow:
    """One window's tensors on the device, the event that ends their copy
    (None on the CPU) and the gather's host metadata (``meta``)."""

    __slots__ = ("tensors", "event", "meta")

    def __init__(self, tensors: Tuple[torch.Tensor, ...], event, meta=None):
        self.tensors, self.event, self.meta = tensors, event, meta

    def consume(self) -> None:
        """Make the tensors ready on the current stream: it waits for the
        copies, and each tensor is marked as used there."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream(self.tensors[0].device)
        stream.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(stream)


class WindowStager:
    """Pinned host slots and a copy stream for one device: ``host(i, ...)``
    hands window i's gather a pinned buffer of slot ``i % SLOTS`` (two: the
    pipeline keeps two windows in flight), after that slot's previous copy
    ended; ``stage(i, tensors)`` copies them to
    the device on the copy stream and records the slot's event. On the CPU
    the buffers are plain host memory and the copy is synchronous."""

    SLOTS = 2

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._bufs: List[Dict[str, torch.Tensor]] = [{} for _ in range(self.SLOTS)]
        self._events: List[Optional[object]] = [None] * self.SLOTS
        self._stream = None

    def host(self, i: int, role: str, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """A host tensor of ``shape`` for window ``i``'s ``role`` (pinned on
        a card), a view of its slot's buffer, grown when too small."""
        k, n = i % self.SLOTS, math.prod(shape)
        with CAPTURE_GATE.shared(queue=False):
            if self._events[k] is not None:
                self._events[k].synchronize()  # the slot's last copy has ended
                self._events[k] = None
            buf = self._bufs[k].get(role)
            if buf is None or buf.dtype != dtype or buf.numel() < n:
                buf = self._bufs[k][role] = torch.empty(max(n, 1), dtype=dtype, pin_memory=self.cuda)
        return buf[:n].view(shape)

    def _copy_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def stage(self, i: int, tensors: Sequence[torch.Tensor], meta=None) -> StagedWindow:
        """Window ``i``'s host tensors (from :meth:`host`) on the device."""
        with CAPTURE_GATE.shared(queue=False):
            if not self.cuda:
                return StagedWindow(tuple(t.clone() for t in tensors), None, meta)
            stream = self._copy_stream()
            with torch.cuda.stream(stream):
                out = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                            for t in tensors)
                for dst, src in zip(out, tensors):
                    dst.copy_(src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            self._events[i % self.SLOTS] = ev
        return StagedWindow(out, ev, meta)
