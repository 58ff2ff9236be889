"""The one-thread fixture of the port's test files, imported by each."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the reduced models' tensors are tiny, and
    with several test workers on the cores a multi-threaded op waits on
    its thread pool far longer than it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
