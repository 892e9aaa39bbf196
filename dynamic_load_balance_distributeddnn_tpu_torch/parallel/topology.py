"""Which device each of a process's workers runs on (the JAX package's
``parallel/topology.py`` ``WorkerTopology``).

In the port a process owns one device, so its topology is that device and
the workers the ``-gpu`` map puts on it; the data axis across processes is
``parallel/mesh.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


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
