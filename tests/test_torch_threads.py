"""One intra-op thread for the port's CPU tests.

The port's tests run tiny tensors. With PyTorch's default, a thread a
core, the OpenMP teams of the parallel test workers oversubscribe the
cores and spin, and a test that takes 0.2 s alone takes 40 s beside five
others. Each port test module imports :func:`one_torch_thread`; the
fixture holds PyTorch at one intra-op thread for that module and restores
the previous count after it, so modules that share a worker process are
not affected."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_module_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1
