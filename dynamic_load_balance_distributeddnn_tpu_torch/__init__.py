"""PyTorch + CUDA port of the dynamic-batch-size (DBS) data-parallel trainer.

A second package beside ``dynamic_load_balance_distributeddnn_tpu`` (the JAX
reference). It trains the vision DBS loop on one NVIDIA Hopper card, where
every logical worker shares the card, or across processes, one a device
(``parallel/``): the solver re-partitions data in inverse proportion to
each worker's measured compute time, and the workers' per-example-weighted
gradients are summed into one SGD-momentum update.

The port imports ``torch`` and numpy and nothing of the JAX package: the
host-side modules it needs (solver, partitioner, datasets, faults, recorder)
are its own copies. The two kernels on the training path — fused GroupNorm
with relu, and softmax cross-entropy — are hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` at first use (``ops/kernels/runtime.py``).

Entry points (``cli.main``, ``train.engine.Trainer``) run on the card unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""

__version__ = "0.1.0"
