"""A fixture for the port's CPU tests of whole models: one intra-op thread.

At the smoke configs' sizes PyTorch's CPU kernels run no slower on one
thread, and in the parallel test run (``-n 6`` workers on a few cores) a
worker's idle OpenMP threads spin against the others' work: a test module
that takes 16 s alone took 846 s beside five others at 8 threads each.
A module takes it with ``from torch_threads import one_torch_thread``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
