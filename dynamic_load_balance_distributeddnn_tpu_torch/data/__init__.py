"""Dataset readers, the LM corpus and the per-epoch data partitioner."""

from dynamic_load_balance_distributeddnn_tpu_torch.data.corpus import (
    Corpus,
    batchify,
    bptt_windows,
)
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
    "Corpus",
    "DatasetBundle",
    "EpochPlan",
    "WorkerPlan",
    "batchify",
    "bptt_windows",
    "build_epoch_plan",
    "load_dataset",
    "partition_indices",
    "synthetic_dataset",
]
