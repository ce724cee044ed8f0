"""One intra-op thread for torch in each test module of the port.

pytest-xdist runs several workers on one host, and each worker's torch
otherwise keeps a pool of one thread per core: the workers' pools then
contend for the same cores and a CPU-bound test runs many times slower than
alone. Each ``tests/test_torch_*.py`` imports ``one_torch_thread``, a
module-scoped autouse fixture that sets the count to 1 for the module's
tests and restores it after them. The ranks that ``_dist_util.launch_local``
starts get their own cap (``OMP_NUM_THREADS``)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
