"""The benchmark's CPU tests run whole tiny cells of 250,000 rows; one
thread each keeps them from crowding the rest of a parallel test run."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
