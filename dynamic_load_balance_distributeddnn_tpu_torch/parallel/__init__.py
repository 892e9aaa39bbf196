"""Data parallelism across processes: the data axis over the ranks and its
collectives (``mesh.py``), each process's workers on its device
(``topology.py``), the quantized gradient wire (``wire.py``) and JAX's
threefry keys on the host (``prng.py``)."""
