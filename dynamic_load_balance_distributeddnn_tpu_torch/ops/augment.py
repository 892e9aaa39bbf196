"""On-device image normalization and augmentation.

The reference augments on the host through torchvision (RandomCrop(32,
padding=4), RandomHorizontalFlip, Normalize); the JAX package does it on the
device, and so does this port: the raw uint8 NHWC batch stays on the card
and crop/flip/normalize run as tensor ops on it.

The crop offsets and flip flags are drawn from an explicit
``torch.Generator``, or passed in by the caller, so a test can inject the
JAX package's draws and compare like with like.
"""

from __future__ import annotations

from typing import Optional

import torch


def normalize_images(x_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> float32 normalized with the dataset stats."""
    x = x_u8.float() / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def augment_images(
    x_u8: torch.Tensor,
    mean,
    std,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[torch.Tensor] = None,
    flips: Optional[torch.Tensor] = None,
    pad: int = 4,
) -> torch.Tensor:
    """Random crop with ``pad`` pixels of zero padding, horizontal flip and
    normalize, one independent draw per example. ``offsets`` ([b, 2] ints in
    [0, 2*pad]) and ``flips`` ([b] bools) are drawn on ``generator``'s
    device unless given."""
    b, h, w, _ = x_u8.shape
    gdev = generator.device if generator is not None else "cpu"
    if offsets is None:
        offsets = torch.randint(0, 2 * pad + 1, (b, 2), generator=generator, device=gdev)
    if flips is None:
        flips = torch.rand(b, generator=generator, device=gdev) < 0.5
    dev = x_u8.device
    offsets = offsets.to(dev, torch.long)
    flips = flips.to(dev, torch.bool)
    x = normalize_images(x_u8, mean, std)
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))  # zeros after normalize
    rows = offsets[:, 0, None] + torch.arange(h, device=dev)  # [b, h]
    cols = offsets[:, 1, None] + torch.arange(w, device=dev)  # [b, w]
    x = xp[torch.arange(b, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    return torch.where(flips[:, None, None, None], x.flip(2), x)
