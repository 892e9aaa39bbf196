"""Per-example losses and the weighted-gradient contract.

The reference combines worker gradients as sum_r (p_r / sum p) * g_r. The
same math, per example: every example e carries a weight w_e with
sum_e w_e == 1 over the global batch, and the combined gradient is the
gradient of sum_e w_e * loss_e. Each worker differentiates its local partial
sum; a plain SUM across workers reproduces the weighted combine exactly:

- DBS mode:  w_e = mask_e / N_total
- ``-de`` mode: w_e = mask_e / (ws * count_r)
"""

from __future__ import annotations

import numpy as np
import torch


def per_example_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy per example, the plain PyTorch version of K2
    (``ops/kernels/xent.py``). logits: [..., V]; labels: [...] int. A label
    outside [0, V) contributes a gold logit of 0, as in the kernels."""
    logz = torch.logsumexp(logits.float(), dim=-1)
    hit = torch.arange(logits.shape[-1], device=logits.device) == labels[..., None].long()
    gold = torch.where(hit, logits.float(), torch.zeros((), device=logits.device)).sum(-1)
    return logz - gold


def example_weights(
    mask: np.ndarray,
    total_true: int,
    worker_count: int,
    world_size: int,
    uniform_worker_weight: bool = False,
) -> np.ndarray:
    """Host-side weight vector for one worker's batch; ``uniform_worker_weight``
    selects the ``-de`` degraded combine."""
    m = mask.astype(np.float32)
    if uniform_worker_weight:
        denom = max(worker_count, 1) * world_size
    else:
        denom = max(total_true, 1)
    return m / float(denom)
