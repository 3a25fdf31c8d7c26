"""One intra-op thread for the CPU tests of the port.

The CPU tests run small tensors, several test processes at once on one
machine.  Each PyTorch op then splits its few elements over as many
OpenMP threads as the machine has cores, in every process at once, and
the threads spend the run waiting for one another: a 300-point window
stream took 10x as long as on one thread.  A test module that imports
``one_torch_thread`` runs its tests on one intra-op thread and restores
the setting after the module.  Results do not depend on it beyond the
order of a parallel reduction's partial sums.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
