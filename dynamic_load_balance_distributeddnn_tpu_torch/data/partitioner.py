"""The dynamic data partitioner — a copy of the JAX package's.

Ownership: a fixed-seed permutation of the example indices is sliced into
contiguous fractions of length ``int(share_r * n)`` per worker. Each epoch
gets an :class:`EpochPlan`: per-worker batch sizes from the balancer, a
per-epoch reshuffle within each worker's shard, and step counts with the
equal-step invariant (``num_steps`` is the max over workers).

The JAX package pads each batch up to a bucket multiple for static shapes;
``padded_batch`` is kept so the plan (and any timing model reading it) is
identical, but the eager PyTorch step runs each batch at its true width.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def partition_indices(
    n: int,
    shares: Sequence[float],
    seed: int = 1234,
    shuffle: bool = True,
) -> List[np.ndarray]:
    """Slice ``n`` example indices into per-worker shards of length
    ``int(share_r * n)`` (the reference's truncation)."""
    shares = np.asarray(shares, dtype=np.float64)
    if shuffle:
        order = np.random.RandomState(seed).permutation(n)
    else:
        order = np.arange(n)
    parts: List[np.ndarray] = []
    lo = 0
    for s in shares:
        ln = int(s * n)
        parts.append(order[lo : lo + ln].copy())
        lo += ln
    return parts


@dataclasses.dataclass(frozen=True)
class WorkerPlan:
    """One worker's slice of an epoch."""

    rank: int
    indices: np.ndarray  # owned example indices, in this epoch's visit order
    batch_size: int  # true per-step batch size (the balancer's decision)
    padded_batch: int  # batch_size rounded up to the bucket multiple
    steps: int  # number of real (non-padding) steps this worker runs


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """The full plan for one epoch: who owns what, at which batch size, for
    how many steps."""

    epoch: int
    shares: np.ndarray
    batch_sizes: np.ndarray
    workers: Tuple[WorkerPlan, ...]
    num_steps: int
    global_batch: int

    def epoch_indices(
        self, rank: int, s0: int = 0, s1: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Worker ``rank``'s steps ``[s0, s1)`` as ``(idx, mask)`` of shape
        ``[s1-s0, padded_batch]``: row i holds the example indices of step
        s0+i (zeros in padding slots) and the mask marks real examples."""
        w = self.workers[rank]
        if s1 is None:
            s1 = self.num_steps
        n = s1 - s0
        idx = np.zeros((n, w.padded_batch), dtype=np.int64)
        mask = np.zeros((n, w.padded_batch), dtype=bool)
        b = max(w.batch_size, 1)
        n_real = max(min(s1, w.steps) - s0, 0)
        if n_real > 0:
            flat = w.indices[s0 * b : (s0 + n_real) * b]
            full_rows, rem = divmod(len(flat), b)
            if full_rows:
                idx[:full_rows, :b] = flat[: full_rows * b].reshape(full_rows, b)
                mask[:full_rows, :b] = True
            if rem:
                idx[full_rows, :rem] = flat[full_rows * b :]
                mask[full_rows, :rem] = True
        return idx, mask


def build_epoch_plan(
    n: int,
    shares: Sequence[float],
    batch_sizes: Sequence[int],
    global_batch: int,
    epoch: int,
    seed: int = 1234,
    bucket: int = 16,
) -> EpochPlan:
    """Plan one epoch: fixed-seed ownership, a per-epoch shuffle of each
    worker's visit order, bucketed batch widths and equal-step counts."""
    shares = np.asarray(shares, dtype=np.float64)
    batch_sizes = np.asarray(batch_sizes, dtype=np.int64)
    parts = partition_indices(n, shares, seed=seed, shuffle=True)
    workers: List[WorkerPlan] = []
    num_steps = 0
    for rank, (owned, b) in enumerate(zip(parts, batch_sizes)):
        b = int(max(b, 1))
        # mod 2**32: RandomState seeds are uint32
        order = np.random.RandomState(
            (seed * 1000003 + epoch * 9176 + rank) % (2**32)
        ).permutation(len(owned))
        visit = owned[order]
        steps = max(-(-len(visit) // b), 1)
        padded = -(-b // bucket) * bucket
        workers.append(
            WorkerPlan(
                rank=rank,
                indices=visit,
                batch_size=b,
                padded_batch=padded,
                steps=steps,
            )
        )
        num_steps = max(num_steps, steps)
    return EpochPlan(
        epoch=epoch,
        shares=shares.copy(),
        batch_sizes=batch_sizes,
        workers=tuple(workers),
        num_steps=num_steps,
        global_batch=int(global_batch),
    )
