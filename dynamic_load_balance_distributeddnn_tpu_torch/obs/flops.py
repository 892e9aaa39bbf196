"""FLOP accounting and MFU (the JAX package's ``obs/flops.py``, for torch).

The JAX package reads a compiled step's FLOPs from XLA's cost model
(``compiled_flops``). Eager PyTorch has no compiled step, so
:func:`step_flops` counts one eager worker step, forward and backward,
under ``torch.utils.flop_counter.FlopCounterMode``. That counter sees the
ATen products and convolutions only (``mm``, ``bmm``, ``addmm``,
``convolution`` and their backwards); XLA's cost model also counts the
elementwise work, so the two differ by a model-dependent ratio
(``tests/test_torch_obs.py`` measures it on MnistNet). The hand-written
kernels are not ATen operations: on the card K1 (GroupNorm), K2
(cross-entropy) and K3 (flash attention) are not counted; on the CPU their
plain versions run, and K3's plain products are counted. At the language
model's T = 35 K3's products are under 1% of a step's.

MFU is reported against the card's **dense bf16 peak** whatever the run's
compute dtype (f32 runs show correspondingly lower MFU); the key name,
``mfu_bf16_peak``, says so.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# Dense (no sparsity) bf16 tensor-core peak, FLOP/s, by CUDA device name.
# Source: NVIDIA's H100 Tensor Core GPU datasheet, H100 SXM (the 80GB HBM3
# part): BF16 Tensor Core 989.4 TFLOP/s dense (1,979 with sparsity), at its
# 700 W power limit.
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def chip_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of the CUDA device (default: the current
    one), or None on the CPU or an unknown card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, peak in _PEAK_BF16.items():
        if name.startswith(prefix):
            return peak
    return None


def step_flops(step: Callable[[], object]) -> Optional[float]:
    """FLOPs of one call of ``step`` (an eager forward and backward) as
    ``FlopCounterMode`` counts them; None when it counts nothing. Run it
    outside any CUDA graph capture: the count needs the eager operations."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step()
    total = float(counter.get_total_flops())
    return total if total > 0 else None


def mfu(flops_per_second: Optional[float], n_devices: int = 1, device=None) -> Optional[float]:
    """Model FLOP utilization in [0, 1] against the devices' aggregate bf16
    peak; None where the peak is unknown (the CPU)."""
    peak = chip_peak_flops(device)
    if peak is None or flops_per_second is None:
        return None
    return flops_per_second / (peak * max(n_devices, 1))
