"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

- ``groupnorm``: K1, fused GroupNorm + relu, forward and backward.
- ``xent``: K2, per-example softmax cross-entropy, forward and backward.
- ``flash_attention``: K3, streaming-softmax attention, forward, dK/dV and dQ.
- ``runtime``: builds ``csrc/*.cu`` with nvcc at first use, loads them with
  ctypes, and keeps the per-kernel launch counts (``LAUNCHES``).
"""
