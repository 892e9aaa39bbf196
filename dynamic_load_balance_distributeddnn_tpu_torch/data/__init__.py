"""Dataset readers and the per-epoch data partitioner."""

from dynamic_load_balance_distributeddnn_tpu_torch.data.datasets import (
    DatasetBundle,
    load_dataset,
    synthetic_dataset,
)
from dynamic_load_balance_distributeddnn_tpu_torch.data.partitioner import (
    EpochPlan,
    WorkerPlan,
    build_epoch_plan,
    partition_indices,
)

__all__ = [
    "DatasetBundle",
    "EpochPlan",
    "WorkerPlan",
    "build_epoch_plan",
    "load_dataset",
    "partition_indices",
    "synthetic_dataset",
]
