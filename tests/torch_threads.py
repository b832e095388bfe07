"""One PyTorch intra-op thread for the port's tests. The xdist workers
share the host's cores, and PyTorch's default of a thread per core
oversubscribes them. Every tests/test_torch_*.py imports ``one_thread``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while the module runs, and ``OMP_NUM_THREADS=1``
    for the processes it starts, which do not inherit
    ``torch.set_num_threads``; both restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)
