"""Which device each of a process's workers runs on, and the topology tree
of the combine across ranks (the JAX package's ``parallel/topology.py``).

In the port a process owns one device, so its ``WorkerTopology`` is that
device and the workers the ``-gpu`` map puts on it; the data axis across
processes is ``parallel/mesh.py``'s.

``TopologyTree`` is the JAX package's factorization of the mesh-ordered
devices into nested contiguous groups, which ``--grad_comm hier`` walks.
Here the devices are the ranks, in rank order (the mesh order), and a
rank's "host" is its hostname (``DataMesh.hosts``): ``factor_hosts`` reads
the blocks of ranks that share a host, as the JAX package reads its
devices' ``process_index``; ``--hier_hosts N`` is the synthetic split of
the ranks into N contiguous blocks, as the JAX package splits its devices
in mesh order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


def factor_hosts(hosts: Sequence, requested: int = 0) -> Optional[int]:
    """The host-group count H such that the rank-ordered ``hosts`` (one
    host name a rank) split into H equal contiguous blocks, each on one
    host. ``requested > 0`` forces a synthetic split into that many blocks
    (a one-host run, the tests, the bench). None when no usable two-level
    structure exists (fewer than two groups, uneven or non-contiguous
    blocks): the caller falls back to the flat combine."""
    n = len(hosts)
    if requested:
        if requested < 2 or requested > n or n % requested:
            return None
        return int(requested)
    by_host: Dict[object, List[int]] = {}
    for i, h in enumerate(hosts):
        by_host.setdefault(h, []).append(i)
    if len(by_host) < 2:
        return None  # one host: no cross-host link to shorten
    if len({len(v) for v in by_host.values()}) != 1:
        return None  # ragged hosts cannot form a rectangular axis
    for idxs in by_host.values():
        if idxs != list(range(idxs[0], idxs[0] + len(idxs))):
            return None  # host blocks must be contiguous in rank order
    return len(by_host)


def parse_hier_levels(spec: str) -> Tuple[Tuple[str, int], ...]:
    """A declared topology spec (``--hier_levels host:4,rack:2``) as
    ``((name, size), ...)`` outermost-first; raises ``ValueError`` on a
    malformed entry (the config check calls it, so a typo fails when the
    flags are parsed)."""
    levels: List[Tuple[str, int]] = []
    seen = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"hier_levels entry {part!r} must be name:size (e.g. host:4)")
        name, _, size_s = part.partition(":")
        name = name.strip()
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(f"hier_levels size {size_s!r} is not an integer")
        if not name or name in seen:
            raise ValueError(f"hier_levels names must be unique, got {name!r}")
        if size < 2:
            raise ValueError(f"hier_levels size for {name!r} must be >= 2")
        seen.add(name)
        levels.append((name, size))
    return tuple(levels)


@dataclasses.dataclass(frozen=True)
class TopologyTree:
    """An N-level factorization of the rank-ordered devices into nested
    contiguous groups. ``levels`` is ``((name, size), ...)`` outermost-first:
    ``levels[0]`` the slowest link class (compressed hardest), the last
    level the fastest (its hop always runs at fp32). The sizes multiply to
    the device count, and a rank's coordinates are its rank in mixed radix,
    the innermost level fastest (row-major, as the JAX ``tree_mesh``).

    ``declared(spec, n)`` (``--hier_levels``), ``from_process_topology(hosts,
    requested)`` (the host/device split, or ``--hier_hosts``) and
    ``learned(candidate, rates)`` (adjacent levels whose measured rates are
    within ``merge_ratio`` merge) build one; ``restrict(n)`` re-derives it
    over a survivor count (for an elastic re-shard)."""

    levels: Tuple[Tuple[str, int], ...]  # outermost-first, innermost last

    def __post_init__(self):
        if len(self.levels) < 2:
            raise ValueError("TopologyTree needs >= 2 levels (else run flat)")
        names = [n for n, _ in self.levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate level names: {names}")
        for name, size in self.levels:
            if size < 2:
                raise ValueError(f"level {name!r} size {size} < 2")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.levels)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.levels)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.levels:
            n *= s
        return n

    def key(self) -> Tuple:
        return tuple(self.levels)

    @classmethod
    def declared(cls, spec: str, n_devices: int) -> Optional["TopologyTree"]:
        """From a ``--hier_levels`` string over ``n_devices``: the declared
        levels are the outer ones; an implicit innermost "device" level
        takes the remainder. None when the declared product does not divide
        the device count (the caller warns and runs flat); a malformed
        string raises."""
        declared = parse_hier_levels(spec)
        if not declared:
            return None
        outer = 1
        for _, s in declared:
            outer *= s
        if outer > n_devices or n_devices % outer:
            return None
        remainder = n_devices // outer
        if remainder >= 2:
            inner_name = "device" if "device" not in {n for n, _ in declared} else "chip"
            levels = declared + ((inner_name, remainder),)
        else:
            levels = declared
        if len(levels) < 2:
            return None
        return cls(levels)

    @classmethod
    def from_process_topology(cls, hosts: Sequence, requested: int = 0) -> Optional["TopologyTree"]:
        """The two-level host/device split of the rank-ordered ``hosts``
        (``factor_hosts``), or the synthetic ``requested`` host count."""
        n_hosts = factor_hosts(hosts, requested)
        if n_hosts is None:
            return None
        per = len(hosts) // n_hosts
        if per < 2:
            return None  # one device a host: a single level, no tree to walk
        return cls((("host", n_hosts), ("device", per)))

    @classmethod
    def learned(cls, candidate: "TopologyTree", level_bytes_per_s: Sequence[float],
                merge_ratio: float = 2.0) -> Optional["TopologyTree"]:
        """Merge adjacent levels of ``candidate`` whose measured rates
        (``probe_link_bandwidth``'s ``level_bytes_per_s``, outermost-first)
        are within ``merge_ratio`` of each other: the sizes multiply and the
        inner name wins. An unmeasured (non-positive) rate inhibits the
        merge. None when everything merges into one level (a symmetric
        fabric: run flat)."""
        if len(level_bytes_per_s) != len(candidate.levels):
            raise ValueError("one measured rate per candidate level")
        merged: List[Tuple[str, int, float]] = []
        for (name, size), rate in zip(candidate.levels, level_bytes_per_s):
            r = float(rate) if rate and rate > 0 else 0.0
            if merged:
                pname, psize, prate = merged[-1]
                if prate > 0 and r > 0 and max(prate, r) / min(prate, r) < merge_ratio:
                    merged[-1] = (name, psize * size, max(prate, r))
                    continue
            merged.append((name, size, r))
        if len(merged) < 2:
            return None
        return cls(tuple((n, s) for n, s, _ in merged))

    def restrict(self, n_devices: int) -> Optional["TopologyTree"]:
        """The tree over a survivor count: outer levels whose size still
        divides the remaining count (leaving at least 2) are kept, the rest
        dropped; the innermost kept level takes the quotient. None when
        fewer than two levels survive (run flat)."""
        if n_devices < 4:
            return None
        kept: List[Tuple[str, int]] = []
        remaining = n_devices
        for name, size in self.levels[:-1]:
            if remaining % size == 0 and remaining // size >= 2:
                kept.append((name, size))
                remaining //= size
        if remaining >= 2:
            inner_name = self.levels[-1][0]
            if any(n == inner_name for n, _ in kept):
                inner_name = inner_name + "_r"
            kept.append((inner_name, remaining))
        if len(kept) < 2:
            return None
        return TopologyTree(tuple(kept))


@dataclasses.dataclass(frozen=True)
class WorkerTopology:
    world_size: int
    devices: Tuple  # the process's devices, in mesh order
    worker_device: Tuple[int, ...]  # local worker rank -> index into devices

    @classmethod
    def build(cls, world_size: int, devices: Sequence, device_ids: Sequence[int]) -> "WorkerTopology":
        if len(device_ids) != world_size:
            raise ValueError("device_ids must have one entry per worker")
        n = len(devices)
        return cls(world_size=world_size, devices=tuple(devices),
                   worker_device=tuple(d % n for d in device_ids))

    @property
    def groups(self) -> Dict[int, List[int]]:
        """device index -> workers on it, in dispatch (rank) order."""
        g: Dict[int, List[int]] = {}
        for r, d in enumerate(self.worker_device):
            g.setdefault(d, []).append(r)
        return g

    @property
    def one_worker_per_device(self) -> bool:
        return self.world_size == len(self.devices) and len(self.groups) == self.world_size

    @property
    def single_group(self) -> bool:
        """Every worker of the process on one device (the reference's
        ``-gpu 0,0,0,0``): the step's combine is local to that device."""
        return len(self.groups) == 1
