"""The DBS partition solver — a copy of the JAX package's numpy solver.

Given each worker's measured compute time ``t_i`` for the last epoch and its
current data share ``p_i``, the next share is

    r_i = k * p_i / t_i,   k = 1 / sum_j(p_j / t_j)

one step straight to the load-balanced fixed point. Real shares snap to an
integer split of the global batch with the reference's rounding rule (floor,
then +1 only for top remainders that are also >= 0.5), and the returned
shares are renormalized over that split.

Copied, not imported, so the port loads nothing of the JAX package; the
tests hold the copy to the original bit for bit (``rebalance`` here is the
JAX package's ``rebalance_py``: there is no native C++ dispatch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def initial_partition(world_size: int) -> np.ndarray:
    """Uniform starting shares: all workers presumed equal."""
    return np.full(world_size, 1.0 / world_size, dtype=np.float64)


def integer_batch_split(shares: np.ndarray, global_batch: int) -> np.ndarray:
    """Snap real-valued shares to integer per-worker batch sizes (floor +
    top-k remainders that are >= 0.5). The sum is <= ``global_batch``."""
    shares = np.asarray(shares, dtype=np.float64)
    ideal = shares * global_batch / shares.sum()
    floors = np.floor(ideal)
    remainder = ideal - floors
    short = int(global_batch - floors.sum())
    if short > 0:
        top_k = np.argsort(remainder, kind="stable")[-short:]
        awarded = top_k[remainder[top_k] >= 0.5]
        floors[awarded] += 1
    return floors.astype(np.int64)


def quantize_batches(
    batch_sizes: np.ndarray, bucket: int, global_batch: int
) -> np.ndarray:
    """Snap integer batch sizes to multiples of ``bucket`` (each worker >= one
    bucket), redistributing by largest remainder so the total equals the
    global batch's bucket count."""
    b = np.asarray(batch_sizes, dtype=np.int64)
    n = len(b)
    units_total = int(global_batch) // int(bucket)
    if units_total < n:
        return b
    units = integer_batch_split(b.astype(np.float64), units_total)
    leftover = units_total - int(units.sum())
    for i in range(n):
        if units[i] < 1 and leftover > 0:
            units[i] += 1
            leftover -= 1
    if leftover > 0:
        ideal = b.astype(np.float64) / max(b.sum(), 1) * units_total
        while leftover > 0:
            i = int(np.argmax(ideal - units))
            units[i] += 1
            leftover -= 1
    for i in range(n):
        while units[i] < 1:
            j = int(np.argmax(units))
            if units[j] <= 1:
                break
            units[j] -= 1
            units[i] += 1
    return units * int(bucket)


def rebalance(
    node_times: np.ndarray,
    shares: np.ndarray,
    global_batch: int,
    max_share: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One DBS update: times + current shares -> (new shares, integer batches).

    ``max_share`` caps any worker's share (excess redistributed pro rata);
    ``None`` is the exact reference behaviour."""
    t = np.asarray(node_times, dtype=np.float64)
    p = np.asarray(shares, dtype=np.float64)
    if t.shape != p.shape:
        raise ValueError("node_times and shares must have the same length")
    if np.any(t <= 0):
        raise ValueError("node_times must be positive")

    speed = p / t
    r = speed / speed.sum()

    if max_share is not None:
        cap = float(max_share)
        if cap * len(r) < 1.0:
            raise ValueError("max_share too small to cover the batch")
        for _ in range(len(r)):
            over = r > cap
            if not over.any():
                break
            excess = (r[over] - cap).sum()
            r[over] = cap
            free = ~over
            r[free] += excess * r[free] / r[free].sum()

    batches = integer_batch_split(r, global_batch)
    total = batches.sum()
    if total <= 0:
        raise ValueError("degenerate split: no worker received any batch")
    new_shares = batches.astype(np.float64) / float(total)
    return new_shares, batches
