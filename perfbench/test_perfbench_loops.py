"""The open loop times each read from its due time until the host sees it
complete, and the closed loop keeps at most ``inflight`` operations
enqueued; both on made-up operations whose timing is known."""
import itertools
import math
import time

import pytest
import torch

from perfbench import harness

CPU = torch.device("cpu")


class _Event:
    """A completion that the card reports ``after`` seconds past its record."""

    def __init__(self, after: float):
        self.at = time.perf_counter() + after

    def query(self) -> bool:
        return time.perf_counter() >= self.at

    def synchronize(self) -> None:
        while not self.query():
            time.sleep(1e-4)


class _Driver:
    def __init__(self, host_s):
        self.host_s = host_s
        self.issued = 0

    def issue(self, op):
        self.issued += 1
        end = time.perf_counter() + self.host_s(self.issued)
        while time.perf_counter() < end:
            pass
        return op

    def keep(self, op, out):
        pass


def _schedule(rate):
    return harness._Peek((i / rate, {"i": i}) for i in itertools.count())


def test_open_loop_times_a_read_until_the_host_sees_it(monkeypatch):
    monkeypatch.setattr(harness, "_mark", lambda device: _Event(0.004))
    stats = harness.open_loop(_Driver(lambda i: 0.001), _schedule(50), 0.4, CPU)
    assert stats.attempted == 20 and stats.done == 20 and stats.failed == 0
    # 1 ms to issue, then 4 ms on the card, seen by the idle loop's polls
    assert all(0.0049 < x < 0.05 for x in stats.latency_s), stats.latency_s


def test_a_read_done_while_the_host_issues_is_seen_after_the_issue(monkeypatch):
    monkeypatch.setattr(harness, "_mark", lambda device: _Event(0.005))
    # two reads 1 ms apart: the first takes the host 0.2 ms, the second 20 ms,
    # so the first completes on the card while the host issues the second
    stats = harness.open_loop(_Driver(lambda i: 0.0002 if i == 1 else 0.020),
                              _schedule(1000), 0.002, CPU)
    assert stats.attempted == 2 and stats.never_done == 0
    first, second = stats.latency_s
    assert 0.019 < first < 0.1, first  # seen when the second issue returned
    assert 0.024 < second < 0.1 and second > first


def test_a_failed_read_counts_as_infinite(monkeypatch):
    class Failing(_Driver):
        def issue(self, op):
            if op["i"] == 3:
                raise RuntimeError("no helper")
            return super().issue(op)

    stats = harness.open_loop(Failing(lambda i: 0.0), _schedule(100), 0.1, CPU)
    assert stats.failed == 1 and stats.done == stats.attempted - 1
    assert math.isinf(stats.latency_s[3]) and sum(map(math.isinf, stats.latency_s)) == 1


def test_a_read_that_never_completes_is_never_done(monkeypatch):
    monkeypatch.setattr(harness, "DONE_GRACE_S", 0.05)
    monkeypatch.setattr(harness, "_mark", lambda device: _Event(3600.0))
    stats = harness.open_loop(_Driver(lambda i: 0.0), _schedule(100), 0.05, CPU)
    assert stats.never_done == stats.attempted == 5
    assert all(math.isinf(x) for x in stats.latency_s)


@pytest.mark.parametrize("inflight", [1, 3])
def test_closed_loop_keeps_at_most_inflight_enqueued(monkeypatch, inflight):
    free = [time.perf_counter()]  # when the made-up card's queue drains

    def mark(device):
        # the card runs one operation at a time, 5 ms each
        free[0] = max(free[0], time.perf_counter()) + 0.005
        return _Event(free[0] - time.perf_counter())

    monkeypatch.setattr(harness, "_mark", mark)
    ops = harness._Peek(iter(itertools.repeat({"i": 0})))
    stats = harness.closed_loop(_Driver(lambda i: 0.0), ops, 0.2, inflight, CPU)
    # one operation each 5 ms finishes, whatever the depth
    assert 0.1 / 0.005 < stats.attempted <= 0.2 / 0.005 + inflight + 1
    assert stats.done == stats.attempted
