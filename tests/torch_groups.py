"""A fixture for the port's tests of code that makes process groups: none
may be left behind.

The dry run (``launch.dryrun``) and the traced captures (``check.traced``)
make their ``fake`` groups inside ``launch.mesh.fake_world``, which takes
each down again; a test that makes a ``gloo`` group destroys it itself.
A group left over would be a leak, and would make the next test module in
this worker fail to make its own, so it fails the test that left it.
A module takes it with ``from torch_groups import no_process_group_left``.
"""
import pytest
import torch.distributed as dist


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized(), \
        f"a {dist.get_backend()!r} process group was left behind"
