"""Losses, on-device augmentation and the CUDA kernels (``ops/kernels``)."""
