"""The spawner (``dist.spawn.spawn_ranks``) reports a rank that dies, on the
CPU over ``gloo``: one that takes SIGSEGV is named with its signal, its body
and the stack its ``faulthandler`` wrote to ``rank<r>.fault``; one that
raises is named with its exception.  The peer that waits for it in the
closing barrier is stopped, so a failed spawn ends in seconds.

The bodies are module-level functions, so that ``spawn`` can pickle them.
"""
import os
import signal
import time

import pytest

from repro_torch.dist.spawn import fault_path, spawn_ranks


def rows_body(rank, world, device, workdir):
    return [{"rank": rank, "world": world, "device": device}]


def segfault_body(rank, world, device, workdir):
    if rank == 1:
        os.kill(os.getpid(), signal.SIGSEGV)
    return [rank]


def raising_body(rank, world, device, workdir):
    if rank == 1:
        raise ValueError("rank 1 refuses its shard")
    time.sleep(60)  # stopped by the spawner once rank 1 has failed
    return [rank]


def test_ranks_rows_come_back_in_rank_order(tmp_path):
    rows = spawn_ranks(rows_body, 2, str(tmp_path), device="cpu", timeout_s=60)
    assert rows == [[{"rank": r, "world": 2, "device": "cpu"}] for r in range(2)]
    assert all(os.path.getsize(fault_path(str(tmp_path), r)) == 0 for r in range(2))


def test_a_rank_that_crashes_is_reported(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as info:
        spawn_ranks(segfault_body, 2, str(tmp_path), device="cpu", timeout_s=60)
    elapsed = time.monotonic() - t0
    msg = str(info.value)
    assert msg.startswith("rank 1 of a world of 2 running test_torch_spawn.segfault_body "
                          "died by SIGSEGV"), msg
    assert "Fatal Python error: Segmentation fault" in msg
    assert 'in segfault_body' in msg  # a stack line from rank1.fault
    assert fault_path(str(tmp_path), 1) in msg
    assert not os.path.exists(os.path.join(str(tmp_path), "rank1.json"))
    assert elapsed < 30, f"the spawn took {elapsed:.1f} s to report the dead rank"


def test_a_rank_that_raises_is_reported(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as info:
        spawn_ranks(raising_body, 2, str(tmp_path), device="cpu", timeout_s=60)
    msg = str(info.value)
    assert msg.startswith("rank 1 of a world of 2 running test_torch_spawn.raising_body "
                          "raised ValueError: rank 1 refuses its shard"), msg
    assert "rank 1's traceback:" in msg and 'in raising_body' in msg
    assert "0 died by SIGTERM" in msg  # the waiting peer was stopped
    assert time.monotonic() - t0 < 30
