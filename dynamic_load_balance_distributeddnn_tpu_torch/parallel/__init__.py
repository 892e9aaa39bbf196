"""Data parallelism across processes: the data axis over the ranks, its
collectives and the topology tree's subgroups (``mesh.py``), each process's
workers on its device and the tree's factorization (``topology.py``), the
quantized gradient wires and the tree spine (``wire.py``) and JAX's
threefry keys on the host (``prng.py``)."""
