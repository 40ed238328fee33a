"""The CPU threads of the port's tests.

Tier-1 runs the suite in six pytest-xdist workers on one host. PyTorch
gives each process an OpenMP team as wide as the host, so six workers
start six teams of that width on the same cores, and their waiting threads
spin against each other's work (the summed times are in CHANGES.md). Each
port test module imports
:func:`port_test_threads`, an autouse fixture that runs the module's tests
(its module-scoped fixtures included) with :data:`THREADS` intra-op
threads and gives the worker its count back afterwards.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def port_test_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, before))
    yield
    torch.set_num_threads(before)


def test_a_port_module_runs_with_few_threads():
    assert torch.get_num_threads() <= THREADS
