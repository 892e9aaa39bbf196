"""The DBS balancer: the inverse-time solver, per-worker time accounting,
and the window-cadence online controller (``balance/controller.py``) with
its replay lab (``balance/replaylab.py``)."""

from dynamic_load_balance_distributeddnn_tpu_torch.balance.solver import (
    ShareTrajectoryPredictor,
    equilibrium_shares,
    initial_partition,
    integer_batch_split,
    quantize_batches,
    rebalance,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance.timing import (
    HostOverheadMeter,
    TimeKeeper,
    exchange_times,
)

__all__ = [
    "HostOverheadMeter",
    "ShareTrajectoryPredictor",
    "TimeKeeper",
    "equilibrium_shares",
    "exchange_times",
    "initial_partition",
    "integer_batch_split",
    "quantize_batches",
    "rebalance",
]
