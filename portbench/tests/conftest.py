"""The benchmark's CPU tests: the cells at the sizes of ``tiny.py``, with
the kernels' plain versions.  Tests that need the card are marked
``gpu`` and skip inside their fixture where there is none."""
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)
