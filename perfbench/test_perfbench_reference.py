"""The frozen reference: GF(2^8) over 0x11D against known products, the
codes' generators against the paper's constructions (and, in this test only,
against the program's), and repair by decoding."""
import itertools

import numpy as np
import pytest
import torch

from perfbench import spec
from perfbench.reference import codes, expect
from perfbench.reference.gf256 import ISA_L_POLY, Field, carryless_mul, field

BENCH = spec.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]

# products over 0x11D worked out by hand: x^8 = x^4+x^3+x^2+1 (0x1D), x^9 =
# 0x3A, x^12 = 0xCD, x^14 = x^4+x+1; (x+1)(x^2+x+1) = x^3+1; 2 * 0x8E = 1
KNOWN = [(0x02, 0x80, 0x1D), (0x80, 0x80, 0x13), (0x03, 0x07, 0x09), (0x1D, 0x02, 0x3A),
         (0x02, 0xE8, 0xCD), (0x02, 0x8E, 0x01), (0x1D, 0x01, 0x1D), (0x00, 0xC3, 0x00)]


@pytest.mark.parametrize("a,b,want", KNOWN)
def test_known_products_over_0x11d(a, b, want):
    f = field(ISA_L_POLY)
    assert int(f.mul[a, b]) == want == carryless_mul(a, b, ISA_L_POLY)


def test_field_tables():
    f = field(ISA_L_POLY)
    assert np.array_equal(f.mul, f.mul.T)
    assert np.array_equal(f.mul[1], np.arange(256))
    assert not f.mul[0].any()
    assert all(f.mul[a, f.inv[a]] == 1 for a in range(1, 256))
    # 2 generates the multiplicative group of 0x11D (ISA-L's exp table)
    powers, x = set(), 1
    for _ in range(255):
        powers.add(x)
        x = int(f.mul[x, 2])
    assert len(powers) == 255


def test_control_field_differs():
    aes = Field(0x11B)
    assert int(aes.mul[0x02, 0x80]) == 0x1B and int(aes.mul[0x53, 0xCA]) == 0x01
    with pytest.raises(ValueError):
        Field(0x100)  # x^8 is not irreducible


def test_matrix_inverse_and_apply():
    f = field(ISA_L_POLY)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (6, 6), dtype=np.uint8)
    a += np.eye(6, dtype=np.uint8) * (a.diagonal() == 0)[:, None].astype(np.uint8)
    try:
        inv = f.inverse(a)
    except ValueError:
        pytest.skip("singular draw")
    assert np.array_equal(f.matmul(a, inv), np.eye(6, dtype=np.uint8))
    x = torch.from_numpy(rng.integers(0, 256, (6, 300), dtype=np.uint8))
    got = f.apply(a, x).numpy()
    want = np.zeros((6, 300), dtype=np.uint8)
    for r, j in itertools.product(range(6), range(6)):
        want[r] ^= f.mul[a[r, j], x[j].numpy()]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_is_systematic_and_mds(name):
    cfg = spec.config(BENCH, name)
    f = field(ISA_L_POLY)
    g = codes.generator(cfg, f)
    ka = cfg["k"] * cfg["alpha"]
    assert g.shape == (cfg["n"] * cfg["alpha"], ka)
    assert np.array_equal(g[:ka], np.eye(ka, dtype=np.uint8))
    for nodes in itertools.combinations(range(cfg["n"]), cfg["k"]):
        rows = np.concatenate([g[codes.node_rows(cfg, i)] for i in nodes])
        f.inverse(rows)  # raises if the k nodes do not hold the data


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_generator_equals_the_programs(name):
    from repro_torch.core.codes.registry import make_code

    cfg = spec.config(BENCH, name)
    code = make_code(cfg["family"], cfg["n"], cfg["k"], cfg["r"])
    assert code.alpha == cfg["alpha"]
    assert np.array_equal(codes.generator(cfg, field(ISA_L_POLY)), code.generator)


@pytest.mark.parametrize("name", CONFIGS)
def test_decoding_rebuilds_every_node(name):
    cfg = dict(spec.config(BENCH, name), sub_bytes=64)
    (_, stripe), = list(expect.true_stripes(cfg, 1, 2**31 + 5, "cpu"))
    a = cfg["alpha"]
    for lost in range(cfg["n"]):
        helpers = {i: stripe[i * a:(i + 1) * a] for i in range(cfg["n"]) if i != lost}
        got = codes.rebuild_from_helpers(cfg, field(ISA_L_POLY), helpers, lost)
        assert torch.equal(got, stripe[codes.node_rows(cfg, lost)])
        wrong = codes.rebuild_from_helpers(cfg, Field(0x11B), helpers, lost)
        assert not torch.equal(wrong, stripe[codes.node_rows(cfg, lost)])
