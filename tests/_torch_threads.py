"""The port's CPU tests run PyTorch on one intra-op thread.

The suite runs files in parallel workers, and PyTorch's thread team per
worker oversubscribes the host's cores, which stalls every small op at its
barrier.  A test module takes the policy with
``from _torch_threads import one_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests, restored after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
