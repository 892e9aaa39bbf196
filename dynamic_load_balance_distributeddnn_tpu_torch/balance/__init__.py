"""The DBS balancer: the inverse-time solver and per-worker time accounting."""

from dynamic_load_balance_distributeddnn_tpu_torch.balance.solver import (
    initial_partition,
    integer_batch_split,
    quantize_batches,
    rebalance,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance.timing import (
    TimeKeeper,
    exchange_times,
)

__all__ = [
    "TimeKeeper",
    "exchange_times",
    "initial_partition",
    "integer_batch_split",
    "quantize_batches",
    "rebalance",
]
