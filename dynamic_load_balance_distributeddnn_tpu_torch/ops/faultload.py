"""On-device synthetic load for straggler injection (``--fault_mode compute``).

The JAX package's ``ops/faultload.py``: the reference slows a straggler with
host ``time.sleep`` slices (dbs.py:103); here the straggler's step burns
real device work instead, a chain of dependent 256 x 256 f32 products
``acc <- tanh(acc @ acc) * 0.5 + 0.5`` whose length is the number of
iterations asked for. The chain is seeded off the worker's weighted loss,
so it runs after the step's forward on the stream.

One iteration is about 34 MFLOP, a few microseconds of an H100 and well
under the host's cost of launching its kernels one by one: an eager Python
loop leaves the card idle (busy 13-21% over 1,000 iterations on an H100
80GB HBM3 at 700 W, ``chip_smoke.py``) and turns the "compute" straggler
into host time. So on a CUDA device :class:`SyntheticLoad` runs the whole
chain as one cooperative kernel (``ops/kernels/faultload.py``,
``csrc/faultload.cu``): one launch whatever the iteration count, no gap
between iterations. On the CPU it runs :func:`synthetic_load`, the plain
chain in the JAX package's form.

``SyntheticLoad.calibrate_iter_cost`` measures the seconds an iteration on
a device (CUDA events on the card), so the injectors can turn "this worker
loses S seconds" into an iteration count, the reference's wait seconds.
"""

from __future__ import annotations

import time
from typing import Dict, Union

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.faultload import SIZE, synthetic_load_cuda


def _body(acc: torch.Tensor) -> torch.Tensor:
    return torch.tanh(acc @ acc) * 0.5 + 0.5


def _seed_matrix(seed_val: torch.Tensor) -> torch.Tensor:
    return torch.full((SIZE, SIZE), 1e-4, dtype=torch.float32, device=seed_val.device) + (
        seed_val.detach().float() * 1e-8
    )


def synthetic_load(n_iters: Union[int, torch.Tensor], seed_val: torch.Tensor) -> torch.Tensor:
    """``n_iters`` dependent products, plain PyTorch, one launch sequence an
    iteration; returns a scalar that depends on every one of them.
    ``n_iters`` is an int or an int32 scalar tensor, the kernel's two
    forms of the count."""
    x = _seed_matrix(seed_val)
    for _ in range(int(n_iters)):
        x = _body(x)
    return torch.sum(x) * 1e-12


class SyntheticLoad:
    """:func:`synthetic_load` through its kernel on a card (the plain chain
    on the CPU), with each device's calibrated cost an iteration."""

    def __init__(self):
        self._iter_cost: Dict[torch.device, float] = {}

    def __call__(self, n_iters: Union[int, torch.Tensor], seed_val: torch.Tensor) -> torch.Tensor:
        if seed_val.is_cuda:
            return synthetic_load_cuda(n_iters, seed_val)
        return synthetic_load(n_iters, seed_val)

    def calibrate_iter_cost(self, device, iters: int = 200) -> float:
        """Seconds a synthetic-load iteration on ``device``, cached per
        device: ``iters`` iterations against one, each timed after a warm
        call, the difference over ``iters - 1``. On a card the times are
        CUDA events around the launch."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        cached = self._iter_cost.get(dev)
        if cached is not None:
            return cached
        seed = torch.zeros((), device=dev)
        self(8, seed)  # build (CUDA) and warm

        def wall(n: int) -> float:
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                self(n, seed)
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            t0 = time.perf_counter()
            float(self(n, seed))
            return time.perf_counter() - t0

        cost = max((wall(iters) - wall(1)) / (iters - 1), 1e-9)
        self._iter_cost[dev] = cost
        return cost
