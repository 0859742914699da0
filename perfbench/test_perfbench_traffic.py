"""The traffic generator and the seeded inputs: deterministic in the seed,
every operation drawn anew from the mix's domains."""
import itertools
from collections import Counter, OrderedDict

import pytest
import torch

from perfbench import data, spec, traffic

BENCH = spec.load_benchmark()
BIG = 2**31 + 977


def _cell(name):
    entry = spec.cell(BENCH, name)
    return spec.config(BENCH, entry["config"]), spec.mix(entry["traffic"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_ops_are_deterministic_in_the_seed(cell):
    cfg, mix = _cell(cell)
    first = list(itertools.islice(traffic.ops(cfg, mix, BIG), 200))
    again = list(itertools.islice(traffic.ops(cfg, mix, BIG), 200))
    assert first == again


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_op_is_one_of_the_mix_and_the_seed_sets_the_order(cell):
    cfg, mix = _cell(cell)
    distinct = traffic.all_ops(cfg, mix)

    def key(op):
        return tuple(sorted(op.items()))

    streams = []
    for seed in (1, 2, BIG):
        ops = list(itertools.islice(traffic.ops(cfg, mix, seed), 1000 * len(distinct)))
        counts = Counter(map(key, ops))
        assert set(counts) == set(map(key, distinct))  # every op of the mix, no other
        assert all(800 < c < 1200 for c in counts.values())  # uniform draws
        streams.append(ops[:50])
    assert streams[0] != streams[1] and streams[1] != streams[2]


def _lru_misses(stream, warm=(), rotations=8, capacity=64):
    """For each recovery call of ``stream``, after ``warm``, whether it
    misses a per-(lost, rotation) LRU cache of ``capacity`` plans, as
    ``DRCFamily1.repair_plan``'s is."""
    cache: OrderedDict = OrderedDict()
    missed = []
    for i, op in enumerate([*warm, *stream]):
        miss = False
        for rot in range(rotations):
            key = (op["lost"], rot)
            if key in cache:
                cache.move_to_end(key)
            else:
                miss = True
                cache[key] = None
                if len(cache) > capacity:
                    cache.popitem(last=False)
        if i >= len(warm):
            missed.append(miss)
    return missed


def _lru_missed_calls(stream, rotations=8, capacity=64):
    """The share of recovery calls that miss such a cache."""
    return sum(_lru_misses(stream, (), rotations, capacity)) / len(stream)


def test_recovery_draws_are_not_a_cycle():
    """A lost node drawn anew for each call: 9 nodes x 8 rotations through a
    64-plan cache miss on about one call in nine, where a fixed cycle over
    the nodes would miss on every call."""
    cfg, mix = _cell("drc_9_6_3.node_recovery")
    ops = list(itertools.islice(traffic.ops(cfg, mix, BIG), 5000))
    assert any(a == b for a, b in zip(ops, ops[1:]))  # a node may be lost twice running
    assert ops[:9] != ops[9:18]
    assert 0.07 < _lru_missed_calls(ops[100:]) < 0.16
    cycle = list(itertools.islice(itertools.cycle(traffic.all_ops(cfg, mix)), 5000))
    assert _lru_missed_calls(cycle) == 1.0


@pytest.mark.parametrize("cell", ["drc_9_6_3.node_recovery", "rs_9_6_3.node_recovery"])
def test_every_seed_misses_the_plan_cache_alike(cell):
    """Each seed relabels one pattern within each kind of node, so after the
    harness's warm-up every seed's calls miss the plan cache at the same
    places, and each call's node is of the same kind."""
    cfg, mix = _cell(cell)
    k = cfg["k"]
    runs = {}
    for seed in (1, 2, 3, BIG):
        ops = list(itertools.islice(traffic.ops(cfg, mix, seed), 900))
        runs[seed] = ops, _lru_misses(ops, traffic.all_ops(cfg, mix, seed))
    (first, misses), *rest = runs.values()
    assert 0.07 < sum(misses) / len(misses) < 0.16
    for ops, other in rest:
        assert other == misses
        assert [op["lost"] < k for op in ops] == [op["lost"] < k for op in first]
        assert ops != first
    assert sorted(op["lost"] for op in traffic.all_ops(cfg, mix, BIG)) == list(range(cfg["n"]))


def test_draw_domains():
    cfg = spec.config(BENCH, "drc_9_6_3")
    mix = {"pool_stripes": 8}
    assert traffic.domain("nodes", cfg, mix) == list(range(9))
    assert traffic.domain("data_nodes", cfg, mix) == list(range(6))
    assert traffic.domain("parity_nodes", cfg, mix) == [6, 7, 8]
    assert traffic.domain("pool", cfg, mix) == list(range(8))
    with pytest.raises(ValueError):
        traffic.domain("racks", cfg, mix)


def test_open_loop_schedule_is_evenly_paced_from_zero():
    cfg = spec.config(BENCH, "drc_9_6_3")
    mix = dict(spec.mix("degraded_read"), rate_per_s=400)
    due = [d for d, _ in itertools.islice(traffic.schedule(cfg, mix, BIG), 50)]
    assert due[0] == 0.0
    assert all(abs(b - a - 1 / 400) < 1e-12 for a, b in zip(due, due[1:]))
    assert [op for _, op in itertools.islice(traffic.schedule(cfg, mix, BIG), 48)] == \
        list(itertools.islice(traffic.ops(cfg, mix, BIG), 48))


def test_seeded_bytes_repeat_and_differ():
    cfg = {"n": 3, "k": 2, "alpha": 2, "sub_bytes": 64}
    pool = data.new_pool(cfg, 3, BIG, "cpu")
    again = data.new_pool(cfg, 3, BIG, "cpu")
    other = data.new_pool(cfg, 3, BIG + 1, "cpu")
    assert torch.equal(pool, again) and not torch.equal(pool, other)
    assert int(pool[:, 4:].count_nonzero()) == 0  # parity rows left for the encode
    for s, rows in data.data_rows(cfg, 3, BIG, "cpu"):
        assert torch.equal(rows, pool[s, :4])
    assert data.rng(BIG, "order").integers(1 << 30) == data.rng(BIG, "order").integers(1 << 30)
    assert data.rng(BIG, "order").integers(1 << 30) != data.rng(BIG, "gaps").integers(1 << 30)
