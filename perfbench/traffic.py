"""The one traffic generator: turns a mix file's parameters and a seed into a
stream of operations and, for an open loop, their due times.

A mix's ``draw`` maps each field of an operation to a domain:

* ``nodes``: every node of the code, ``0 .. n-1``;
* ``data_nodes`` / ``parity_nodes``: ``0 .. k-1`` / ``k .. n-1``;
* ``pool``: the stripes of the mix's pool, ``0 .. pool_stripes-1``.

Every seed gets the same work in another order of its values.  The
pattern of draws, each field of each operation drawn anew, uniformly and
independently, is made once by a generator that no seed changes; the seed
draws, for each field, a permutation of its domain that maps each value onto
one of its kind (a data node onto a data node, a parity node onto a parity
node) and relabels the pattern with it.  So the same seed gives the same
stream; every seed repeats its operations alike, and meets any cache of the
program keyed by those fields with the same hits and misses, where draws
made by the seed itself would change the number of misses from seed to seed;
and no seed sends the operations in a fixed cycle, which such a cache could
meet only at its worst.  An open loop (``"loop": "open"``) offers them
evenly paced at ``rate_per_s``.
"""
from __future__ import annotations

import itertools
from typing import Iterator

from . import data

CHUNK = 4096  # draws made at once
PATTERN_SEED = 0  # the generator of every mix's pattern


def domain(name: str, cfg: dict, mix: dict) -> list[int]:
    n, k = cfg["n"], cfg["k"]
    if name == "nodes":
        return list(range(n))
    if name == "data_nodes":
        return list(range(k))
    if name == "parity_nodes":
        return list(range(k, n))
    if name == "pool":
        return list(range(mix["pool_stripes"]))
    raise ValueError(f"unknown draw domain {name!r}")


def kinds(name: str, cfg: dict, mix: dict) -> list[list[int]]:
    """The values of a domain, split by kind: ``nodes`` into its data and
    its parity nodes, every other domain whole."""
    if name == "nodes":
        return [domain("data_nodes", cfg, mix), domain("parity_nodes", cfg, mix)]
    return [domain(name, cfg, mix)]


def _domains(cfg: dict, mix: dict, seed: int) -> tuple[list[str], list[list[int]]]:
    """The fields drawn, and each one's domain in the order its draws index,
    relabelled by the seed within each kind."""
    fields = sorted(mix["draw"])
    domains = []
    for f in fields:
        name = mix["draw"][f]
        gen = data.rng(seed, "labels/" + f)
        image = {}
        for kind in kinds(name, cfg, mix):
            image.update(zip(kind, gen.permutation(kind).tolist()))
        domains.append([image[v] for v in domain(name, cfg, mix)])
    return fields, domains


def all_ops(cfg: dict, mix: dict, seed: int = PATTERN_SEED) -> list[dict[str, int]]:
    """Every distinct operation of the mix, once: the product of the
    ``draw`` domains in the order of their relabelling by ``seed`` (what the
    warm-up and the counting pass run)."""
    fields, domains = _domains(cfg, mix, seed)
    return [dict(zip(fields, values)) for values in itertools.product(*domains)]


def ops(cfg: dict, mix: dict, seed: int) -> Iterator[dict[str, int]]:
    """The endless operation stream of one run."""
    fields, domains = _domains(cfg, mix, seed)
    gen = data.rng(PATTERN_SEED, "ops")
    while True:
        picks = [gen.integers(len(d), size=CHUNK).tolist() for d in domains]
        for row in zip(*picks):
            yield {f: d[i] for f, d, i in zip(fields, domains, row)}


def schedule(cfg: dict, mix: dict, seed: int) -> Iterator[tuple[float, dict[str, int]]]:
    """(due offset in seconds, operation) of an open loop, the first due at 0."""
    gap = 1.0 / float(mix["rate_per_s"])
    for i, op in enumerate(ops(cfg, mix, seed)):
        yield i * gap, op
