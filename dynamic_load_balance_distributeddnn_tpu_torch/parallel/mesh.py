"""The data axis across processes (the JAX package's ``parallel/mesh.py``).

The JAX package's data axis is an XLA mesh over every process's chips, its
collectives XLA's. The port runs **one process a device**: a rank owns one
local device (``cuda:<ordinal>``, or the CPU when asked) and the data axis
is the ``torch.distributed`` world. The reference rendezvous
(``MASTER_ADDR``/``PORT`` and ``init_process_group('gloo')``) is
:func:`initialize_multihost`, from ``--coordinator host:port``.

**The backend rule** (one place, :func:`choose_backend`): NCCL when every
rank owns a distinct CUDA device; gloo on the CPU and when ranks share a
card (NCCL puts no two ranks on one GPU, gloo does: the reference's
``-gpu 0,0`` contention arrangement across processes). The default process
group is always gloo: it carries the host's metadata (the time vectors, the
probe vote, the skip decision, the evaluation's sums). Under NCCL the
gradient collectives ride a second group over the same ranks.

Under gloo every collective of a CUDA tensor is staged explicitly through a
pinned host buffer (one per shape and slot, allocated once): the device
tensor is copied into it, the stream synchronized, gloo runs on the host
copy, and the result is copied back on the stream. One code path, whatever
gloo's own CUDA support.
"""

from __future__ import annotations

import datetime
import socket
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DEFAULT_TIMEOUT_S = 600.0


def initialize_multihost(coordinator: Optional[str], num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """The rendezvous: the default (gloo) process group from
    ``coordinator`` (``host:port``, reached as ``tcp://host:port``; an
    address with a scheme, such as ``file:///path``, is used as it is).
    No-op without a coordinator; an already-initialised group is reused (a
    caller, the tests for one, may rendezvous first). Returns whether a
    process group exists after the call."""
    if dist.is_initialized():
        return True
    if not coordinator:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "--coordinator needs --num_processes and --process_id (or DBS_NUM_PROCESSES "
            "and DBS_PROCESS_ID): torch.distributed has no autodetection"
        )
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        "gloo", init_method=url, world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def device_ident(device: torch.device) -> Tuple[str, str]:
    """``(hostname, device)`` naming a rank's device uniquely across the
    world: a CUDA device by its UUID where torch reports one."""
    device = torch.device(device)
    if device.type != "cuda":
        return socket.gethostname(), "cpu"
    props = torch.cuda.get_device_properties(device)
    return socket.gethostname(), f"cuda:{getattr(props, 'uuid', device.index)}"


def choose_backend(idents: Sequence[Tuple[str, str]]) -> str:
    """The backend rule: ``"nccl"`` when every rank owns a distinct CUDA
    device, else ``"gloo"`` (a CPU rank, or two ranks on one card)."""
    cuda = all(d.startswith("cuda:") for _, d in idents)
    distinct = len(set(idents)) == len(idents)
    return "nccl" if cuda and distinct else "gloo"


class DataMesh:
    """The data axis: the world's ranks, one device each, rank order the
    mesh order. ``size`` is the axis size (:func:`axis_size`), ``rank`` this
    process's position, ``backend`` the gradient collectives' backend,
    ``hosts`` each rank's hostname (bytes count "across hosts" only between
    ranks on different hosts). With no process group it is the one-rank
    axis, on which every collective is the identity."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.size = process_count()
        self.rank = process_index()
        idents = [device_ident(self.device)]
        if self.size > 1:
            idents = [None] * self.size
            dist.all_gather_object(idents, device_ident(self.device))
        self.idents = [tuple(i) for i in idents]
        self.hosts = [h for h, _ in self.idents]
        self.backend = choose_backend(self.idents) if self.size > 1 else "none"
        self.group = None
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)  # NCCL's communicator binds the current device
            self.group = dist.new_group(backend="nccl")  # every rank calls it, in order
        # gloo of a CUDA tensor: through a pinned host buffer
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._pinned: Dict[tuple, torch.Tensor] = {}

    @property
    def cross_host(self) -> bool:
        return len(set(self.hosts)) > 1

    def describe(self) -> Dict[str, object]:
        return {"backend": self.backend, "size": self.size, "rank": self.rank,
                "hosts": self.hosts, "staged_through_host": self.staged}

    # ------------------------------------------------------------ staging

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        key = (slot, t.numel(), t.dtype)
        h = self._pinned.get(key)
        if h is None:
            h = self._pinned[key] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        return h

    def _to_host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        h = self._host(t, slot)
        h.copy_(t.reshape(-1), non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()  # gloo reads the host copy
        return h

    # -------------------------------------------------------- collectives

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place sum (or ``"max"``) of a contiguous tensor over the axis."""
        if self.size == 1:
            return t
        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        if self.staged:
            h = self._to_host(t, "reduce")
            dist.all_reduce(h, rop)
            t.reshape(-1).copy_(h, non_blocking=True)
        else:
            dist.all_reduce(t, rop, group=self.group)
        return t

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """``out`` (``inp.numel() / size`` elements) = this rank's block of
        the sum of ``inp`` over the axis."""
        if self.size == 1:
            return out.copy_(inp)
        fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        if self.staged:
            h_in = self._to_host(inp, "scatter_in")
            h_out = self._host(out, "scatter_out")
            fn(h_out, h_in)
            out.copy_(h_out, non_blocking=True)
        else:
            fn(out, inp, group=self.group)
        return out

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """``out`` = every rank's ``inp``, concatenated in rank order."""
        if self.size == 1:
            return out.copy_(inp)
        fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        if self.staged:
            h_in = self._to_host(inp, "gather_in")
            h_out = self._host(out, "gather_out")
            fn(h_out, h_in)
            out.copy_(h_out, non_blocking=True)
        else:
            fn(out, inp, group=self.group)
        return out


def data_mesh(device) -> DataMesh:
    """The data axis over every rank (the JAX ``data_mesh``)."""
    return DataMesh(device)


def axis_size(mesh: Optional[DataMesh]) -> int:
    """The data axis's size: the group's (1 without one)."""
    return 1 if mesh is None else mesh.size


def allgather_host(values: np.ndarray) -> np.ndarray:
    """Every rank's float64 vector (one length on every rank), concatenated
    in rank order, over the default group; the identity in one process."""
    v = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float64).reshape(-1))
    if process_count() == 1:
        return v.numpy().copy()
    parts = [torch.empty_like(v) for _ in range(process_count())]
    dist.all_gather(parts, v)
    return torch.cat(parts).numpy()


def broadcast_flag(flag: bool) -> bool:
    """Process 0's ``flag`` on every rank (the identity in one process)."""
    if process_count() == 1:
        return bool(flag)
    box = [bool(flag)]
    dist.broadcast_object_list(box, 0)
    return bool(box[0])
