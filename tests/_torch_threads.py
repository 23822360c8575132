"""A module fixture for the port's heavier CPU test files, which use it
with ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``."""
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch intra-op thread while the module runs: xdist's workers
    share the cores, and torch's default pool (a thread a core in every
    worker) then oversubscribes them, ~5x slower under load; every
    comparison is between results computed under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
