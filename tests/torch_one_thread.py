"""One intra-op thread for torch in the port's tests.

Every ``tests/test_torch_*.py`` imports the fixture below by name, which
makes it autouse in that file; ``tests/test_torch_package.py`` checks that
none goes without it."""

import pytest


@pytest.fixture(scope="session", autouse=True)
def torch_on_one_thread():
    """The suite runs several test processes on the host's cores, and its
    small shapes gain nothing from more threads."""
    import torch

    torch.set_num_threads(1)
