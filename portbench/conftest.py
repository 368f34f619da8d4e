"""The harness's CPU tests run the program's plain PyTorch path on small
tensors, where torch's intra-op threads cost more than they give (several
times over when the suite runs several workers on the same cores): each test
module runs on one thread and restores the count after."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
