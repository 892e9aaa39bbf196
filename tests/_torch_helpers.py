"""Shared fixtures of the PyTorch port's tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run each port test module with one intra-op thread. The suite runs in
    several worker processes at once, and PyTorch's default of one thread
    per core in each of them oversubscribes the host, which skews the
    wall-clock probes of tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
