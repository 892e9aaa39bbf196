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

:class:`ShareTrajectoryPredictor` predicts the next epoch's share vector,
and through the plan builder's own cap, split and quantization its batch
sizes: the step keys that the warm service (``runtime/compiler.py``)
captures ahead of the epoch that will replay them.
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


def equilibrium_shares(rates: np.ndarray) -> np.ndarray:
    """The inverse-time fixed point for per-worker seconds an example:
    share_i ∝ 1/c_i, the partition at which every worker's step takes the
    same wall. ``--elastic``'s readmission seeds a returning worker's share
    here from its probed cost (``train/engine.py`` ``_maybe_readmit``)."""
    c = np.asarray(rates, dtype=np.float64)
    if np.any(c <= 0) or not np.isfinite(c).all():
        raise ValueError("rates must be positive and finite")
    inv = 1.0 / c
    return inv / inv.sum()


class ShareTrajectoryPredictor:
    """One-step-ahead prediction of the solver's share vector (the JAX
    package's ``balance/solver.py`` class, copied).

    The DBS update is a fixed-point iteration (r_i ∝ 1/c_i): after
    convergence consecutive share vectors are identical, and during the
    transient they move along a smooth trajectory. A step graph's key holds
    every worker's batch shape, and the tuple the next epoch dispatches is a
    deterministic function of the next share vector, so predicting the
    shares predicts the keys.

    ``observe`` feeds each epoch's realized shares; ``predict`` returns the
    last shares plus an EMA of the per-worker share deltas (``alpha``
    weights the newest delta). A change of world size restarts the track.
    A converged run predicts the tuple it already dispatches, and the
    speculation is then one lookup. Pure host-side numpy."""

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self._last: Optional[np.ndarray] = None
        self._velocity: Optional[np.ndarray] = None

    def observe(self, shares: np.ndarray) -> None:
        s = np.asarray(shares, dtype=np.float64).copy()
        if self._last is not None and s.shape == self._last.shape:
            delta = s - self._last
            if self._velocity is None:
                self._velocity = delta
            else:
                self._velocity = self.alpha * delta + (1.0 - self.alpha) * self._velocity
        elif self._last is not None:
            self._velocity = None  # world size changed: restart the track
        self._last = s

    def predict(self) -> Optional[np.ndarray]:
        """Next epoch's expected share vector (normalized, floor-clamped),
        or None before the first observation."""
        if self._last is None:
            return None
        p = self._last if self._velocity is None else self._last + self._velocity
        p = np.clip(p, 1e-9, None)
        return p / p.sum()

    def predict_batches(
        self,
        global_batch: int,
        bucket: int = 0,
        max_share: Optional[float] = None,
    ) -> Optional[np.ndarray]:
        """Predicted integer per-worker batch sizes through the plan
        builder's pipeline (share cap, integer split, bucket quantization),
        so a right share prediction gives the exact batch tuple of the next
        plan. An infeasible cap (``max_share * workers < 1``) raises."""
        p = self.predict()
        if p is None:
            return None
        if max_share is not None:
            cap = float(max_share)
            if cap * len(p) < 1.0:
                raise ValueError(
                    f"max_share={cap} is infeasible for {len(p)} workers "
                    "(cap * n_workers must be >= 1)"
                )
            for _ in range(len(p)):
                over = p > cap
                if not over.any():
                    break
                excess = (p[over] - cap).sum()
                p[over] = cap
                free = ~over
                p[free] += excess * p[free] / p[free].sum()
        batches = integer_batch_split(p, global_batch)
        if bucket > 0:
            batches = quantize_batches(batches, bucket, global_batch)
        return batches
