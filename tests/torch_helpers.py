"""Shared helpers for the port's tests (``tests/test_torch_*.py``)."""

import pytest
import torch

# the suite runs in several worker processes at once; one intra-op thread
# each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip when this machine has none. The
    decision is made here, when a test runs, never at import or
    collection time: every test worker collects the same tests."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return "cuda:0"
