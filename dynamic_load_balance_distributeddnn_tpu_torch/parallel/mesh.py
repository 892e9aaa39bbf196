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
gloo's own CUDA support. Besides the sums and gathers, an axis shifts a
tensor to the next rank (:meth:`_Axis.permute`, the JAX ``ppermute`` of
ring attention) and exchanges blocks between every pair of ranks
(:meth:`_Axis.all_to_all`, Ulysses attention), staged the same way.

**The topology tree** (``--grad_comm hier``): the JAX package reshapes its
devices into an N-level ``tree_mesh`` and reduces over one named axis at a
time. Here a level of the tree is a set of ``torch.distributed`` subgroups
over ranks: the ranks whose coordinates differ in that level alone, the
coordinates being a rank's index in mixed radix over the level sizes
(innermost fastest, the JAX row-major order). :meth:`DataMesh.tree_axes`
makes every subgroup of every level on every rank, in one order (each
``dist.new_group`` is a collective of the whole world), and returns the
:class:`SubAxis` of each level that holds this rank, outermost first; a
group's ranks are ascending, so its rank order is the level's coordinate
order, as the JAX axis's. A sub-axis runs the collectives of
:class:`DataMesh` on its group, staged the same way; its pinned buffers are
keyed by the level as well as by the slot, shape and dtype.
:func:`probe_link_bandwidth` times the tree's phases against one flat sum.
"""

from __future__ import annotations

import datetime
import socket
import time
from typing import Dict, List, Optional, Sequence, Tuple

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


class _Axis:
    """The collectives of one axis (``size`` ranks, this one ``rank`` in
    it) on ``group`` (None: the default group), staged through pinned host
    memory when ``staged``; the buffers are ``_pinned``'s, keyed by
    ``_tag``, the slot, the element count and the dtype."""

    size: int
    rank: int
    group = None
    staged = False
    _pinned: Dict[tuple, torch.Tensor]
    _tag = ""

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        key = (self._tag, slot, t.numel(), t.dtype)
        h = self._pinned.get(key)
        if h is None:
            h = self._pinned[key] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        return h

    def _to_host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        h = self._host(t, slot)
        h.copy_(t.reshape(-1), non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()  # gloo reads the host copy
        return h

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place sum (or ``"max"``) of a contiguous tensor over the axis."""
        if self.size == 1:
            return t
        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        if self.staged:
            h = self._to_host(t, "reduce")
            dist.all_reduce(h, rop, group=self.group)
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
            fn(h_out, h_in, group=self.group)
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
            fn(h_out, h_in, group=self.group)
            out.copy_(h_out, non_blocking=True)
        else:
            fn(out, inp, group=self.group)
        return out

    def _peer(self, i: int) -> int:
        """The global rank of this axis's rank ``i``."""
        return i

    def permute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """A new tensor holding the ``t`` of rank ``(rank - shift) % size``:
        each rank sends its ``t`` to ``(rank + shift) % size`` (the JAX
        ``ppermute`` with ``perm = [(i, (i + shift) % n)]``). ``t`` has
        one shape on every rank."""
        send = t.contiguous()
        out = torch.empty_like(send)
        if self.size == 1 or shift % self.size == 0:
            return out.copy_(send)
        dst = self._peer((self.rank + shift) % self.size)
        src = self._peer((self.rank - shift) % self.size)
        if self.staged:
            send = self._to_host(send, "shift_out")
            recv = self._host(out, "shift_in")
        else:
            recv = out
        ops = [dist.P2POp(dist.isend, send.reshape(-1), dst, group=self.group),
               dist.P2POp(dist.irecv, recv.reshape(-1), src, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if self.staged:
            out.reshape(-1).copy_(recv, non_blocking=True)
        return out

    def all_to_all(self, inp: torch.Tensor) -> torch.Tensor:
        """A new tensor of ``inp``'s shape whose block ``j`` (of ``size``
        equal blocks along dim 0) is rank ``j``'s block ``rank``: each rank
        sends its block ``j`` to rank ``j`` (the JAX ``all_to_all``)."""
        inp = inp.contiguous()
        out = torch.empty_like(inp)
        if self.size == 1:
            return out.copy_(inp)
        if self.staged:
            h_in = self._to_host(inp, "a2a_in")
            h_out = self._host(out, "a2a_out")
            dist.all_to_all_single(h_out, h_in, group=self.group)
            out.reshape(-1).copy_(h_out, non_blocking=True)
        else:
            dist.all_to_all_single(out.view(-1), inp.view(-1), group=self.group)
        return out


class SubAxis(_Axis):
    """One level of the topology tree as seen from this rank: its group of
    ``ranks`` (ascending, so a rank's index is its coordinate on the
    level), made by :meth:`DataMesh.tree_axes`."""

    def __init__(self, mesh: "DataMesh", name: str, ranks: Sequence[int], group):
        self.name, self.ranks, self.group = name, tuple(ranks), group
        self.size = len(self.ranks)
        self.rank = self.ranks.index(mesh.rank)
        self.staged, self._pinned = mesh.staged, mesh._pinned
        self._tag = f"{name}:{self.ranks}"

    def _peer(self, i: int) -> int:
        return self.ranks[i]


def tree_coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """``rank``'s coordinate on each level (outermost first): its index in
    mixed radix over ``sizes``, the innermost level fastest."""
    coords = []
    for s in reversed(tuple(sizes)):
        coords.append(rank % s)
        rank //= s
    return tuple(reversed(coords))


def tree_groups(sizes: Sequence[int], level: int) -> List[Tuple[int, ...]]:
    """Every group of ``level``: the ranks whose coordinates differ in that
    level alone, each group ascending, the groups in the order of their
    first rank."""
    n = 1
    for s in sizes:
        n *= s
    groups: Dict[tuple, List[int]] = {}
    for r in range(n):
        c = tree_coords(r, sizes)
        groups.setdefault(c[:level] + c[level + 1:], []).append(r)
    return sorted((tuple(g) for g in groups.values()), key=lambda g: g[0])


class DataMesh(_Axis):
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
        self._pinned = {}
        self._tree_axes: Dict[tuple, List[SubAxis]] = {}

    @property
    def cross_host(self) -> bool:
        return len(set(self.hosts)) > 1

    def describe(self) -> Dict[str, object]:
        return {"backend": self.backend, "size": self.size, "rank": self.rank,
                "hosts": self.hosts, "staged_through_host": self.staged}

    def tree_axes(self, names: Sequence[str], sizes: Sequence[int]) -> List[SubAxis]:
        """This rank's :class:`SubAxis` of each level of the tree
        ``(names, sizes)`` (outermost first), whose sizes multiply to the
        axis size. The first call for a tree makes every group of every
        level, level by level, on every rank (a collective: each rank must
        ask for the same trees in the same order); later calls reuse them."""
        names, sizes = tuple(names), tuple(int(s) for s in sizes)
        n = 1
        for s in sizes:
            n *= s
        if len(names) != len(sizes) or n != self.size:
            raise ValueError(f"{self.size} ranks do not factor into levels "
                             f"{list(zip(names, sizes))}")
        key = (names, sizes)
        if key not in self._tree_axes:
            backend = "nccl" if self.backend == "nccl" else "gloo"
            axes = []
            for level, name in enumerate(names):
                mine = None
                for ranks in tree_groups(sizes, level):
                    g = dist.new_group(list(ranks), backend=backend)
                    if self.rank in ranks:
                        mine = SubAxis(self, name, ranks, g)
                axes.append(mine)
            self._tree_axes[key] = axes
        return self._tree_axes[key]


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


def allgather_object(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, over the default
    group; ``[obj]`` in one process."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    """Every rank of the default group meets here (nothing in one
    process)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Process 0's ``obj`` (picklable) on every rank (the identity in one
    process)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def probe_link_bandwidth(mesh: DataMesh, names: Sequence[str], sizes: Sequence[int],
                         floats_per_device: int = 1 << 18, reps: int = 3, tracer=None,
                         gate_ratio: float = 0.95) -> Dict[str, object]:
    """The JAX package's bandwidth probe of a tree (``parallel/mesh.py``
    ``probe_link_bandwidth``), over this rank's sub-axes: the three phases
    of the tree combine timed alone at full precision (the reduce-scatter
    cascade over the inner levels, innermost first; a sum over the
    outermost level on the scattered chunk; the all-gather cascade back),
    one flat sum of the whole payload over every rank, and each level's
    sum on the chunk alone (``level_bytes_per_s``, outermost first: what
    ``TopologyTree.learned`` and ``wire.choose_wires`` read). Each timing is
    the least of ``reps`` after a warm run, each run started behind a
    barrier of every rank and ended by a device synchronize. Every rank
    runs it (its collectives are the world's); the numbers are this rank's,
    so the caller takes one rank's for all (:func:`broadcast_object`).
    ``hier_wins`` is the tree's three phases against ``gate_ratio`` times
    the flat sum. Each phase runs in its span (``comm_reduce_scatter``,
    ``comm_dcn``, ``comm_gather``, ``comm_flat_ref``, ``comm_level_<name>``,
    category ``comm``)."""
    if tracer is None:
        from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer

        tracer = get_tracer()
    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    axes = mesh.tree_axes(names, sizes)
    n_h = sizes[0]
    n_d = 1
    for s in sizes[1:]:
        n_d *= s
    c = -(-floats_per_device // n_d) * n_d  # the payload a device, divisible by the inner groups
    dev = mesh.device
    x_full = torch.zeros(c, dtype=torch.float32, device=dev)
    x_chunk = torch.zeros(c // n_d, dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def rs():
        v = x_full
        for a in reversed(axes[1:]):  # innermost first, as the tree walks
            v = a.reduce_scatter(torch.empty(v.numel() // a.size, device=dev), v)

    def ag():
        v = x_chunk
        for a in axes[1:]:
            v = a.all_gather(torch.empty(v.numel() * a.size, device=dev), v)

    def timed(name: str, fn) -> float:
        fn()  # warm
        best = float("inf")
        with tracer.span(name, cat="comm"):
            for _ in range(reps):
                sync()
                if process_count() > 1:
                    dist.barrier()
                t0 = time.perf_counter()
                fn()
                sync()
                best = min(best, time.perf_counter() - t0)
        return best

    walls = {
        "comm_reduce_scatter": timed("comm_reduce_scatter", rs),
        "comm_dcn": timed("comm_dcn", lambda: axes[0].all_reduce_(x_chunk.clone())),
        "comm_gather": timed("comm_gather", ag),
    }
    flat_wall = timed("comm_flat_ref", lambda: mesh.all_reduce_(x_full.clone()))
    hier_wall = sum(walls.values())
    ici_wall = 0.5 * (walls["comm_reduce_scatter"] + walls["comm_gather"])
    chunk_bytes = (c // n_d) * 4
    level_walls = [timed(f"comm_level_{a.name}", lambda a=a: a.all_reduce_(x_chunk.clone()))
                   for a in axes]
    return {
        "ici_bytes_per_s": (c * 4) / max(ici_wall, 1e-9),
        "dcn_bytes_per_s": chunk_bytes / max(walls["comm_dcn"], 1e-9),
        "level_bytes_per_s": [chunk_bytes / max(w, 1e-9) for w in level_walls],
        "levels": [[a, int(s)] for a, s in zip(names, sizes)],
        "phase_s": {k: round(v, 6) for k, v in walls.items()},
        "flat_wall_s": round(flat_wall, 6),
        "hier_wall_s": round(hier_wall, 6),
        "hier_wins": bool(hier_wall < gate_ratio * flat_wall),
        "gate_ratio": float(gate_ratio),
        "wall_ratio": round(hier_wall / max(flat_wall, 1e-9), 4),
        "hosts": int(n_h),
        "devices_per_host": int(n_d),
        "measured_on_rank": mesh.rank,
    }
