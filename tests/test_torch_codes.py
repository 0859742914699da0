"""Port parity: the copied plan layer must not drift from the reference.

For every code the paper evaluates (``PAPER_CODES``) and every failed node,
the port's copy gives the reference's generator, repair-plan sends, decode
matrix, target order and traffic accounting, and its encode/decode on
torch tensors gives the reference's bytes.  Exact equality throughout.
"""
import numpy as np
import pytest
import torch

from repro.core.code_base import drc_min_cross_rack_blocks as r_eq3
from repro.core.codes import PAPER_CODES, make_code as r_make_code

from repro_torch.core.code_base import drc_min_cross_rack_blocks
from repro_torch.core.codes import PAPER_CODES as T_PAPER_CODES
from repro_torch.core.codes import make_code


def _sends(sends):
    return [(s.src, s.dst, s.matrix) for s in sends]


def _assert_sends_equal(got, want):
    assert len(got) == len(want)
    for (gs, gd, gm), (ws, wd, wm) in zip(_sends(got), _sends(want)):
        assert (gs, gd) == (ws, wd)
        np.testing.assert_array_equal(gm, wm)


def test_paper_code_lists_equal():
    assert T_PAPER_CODES == PAPER_CODES


@pytest.mark.parametrize("spec", PAPER_CODES, ids=lambda s: "%s%d%d%d" % s)
def test_plans_identical_to_reference(spec):
    ref, port = r_make_code(*spec), make_code(*spec)
    assert (port.name, port.n, port.k, port.r, port.alpha) == (
        ref.name, ref.n, ref.k, ref.r, ref.alpha)
    np.testing.assert_array_equal(port.generator, ref.generator)
    for failed in range(ref.n):
        rp, tp = ref.repair_plan(failed), port.repair_plan(failed)
        _assert_sends_equal(tp.node_sends, rp.node_sends)
        _assert_sends_equal(tp.relayer_sends, rp.relayer_sends)
        np.testing.assert_array_equal(tp.decode, rp.decode)
        assert tp.target_order == rp.target_order
        assert tp.traffic_blocks() == rp.traffic_blocks()
        assert tp.coefficient_check(port.all_node_coeffs())


@pytest.mark.parametrize("spec", [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3),
                                  ("MSR", 6, 3, 3)], ids=lambda s: "%s%d%d%d" % s)
def test_encode_decode_match_reference(spec):
    ref, port = r_make_code(*spec), make_code(*spec)
    rng = np.random.default_rng(sum(spec[1:]))
    data = rng.integers(0, 256, size=(ref.k * ref.alpha, 96), dtype=np.uint8)
    want = ref.encode(data)
    got = port.encode(torch.from_numpy(data))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    avail = {i: got[i] for i in range(ref.n - ref.k, ref.n)}  # a parity-heavy set
    dec = port.decode(avail).numpy()
    np.testing.assert_array_equal(dec, ref.decode({i: want[i] for i in avail}))
    np.testing.assert_array_equal(dec, data)


@pytest.mark.parametrize("nkr", [(6, 4, 3), (8, 6, 4), (9, 6, 3), (6, 3, 3), (9, 5, 3),
                                 (8, 4, 2)])
def test_drc_cross_rack_blocks_meet_eq3(nkr):
    code = make_code("DRC", *nkr)
    assert drc_min_cross_rack_blocks(*nkr) == r_eq3(*nkr)
    for failed in range(code.n):
        blocks = code.repair_plan(failed).traffic_blocks()["cross_rack_blocks"]
        assert blocks == pytest.approx(drc_min_cross_rack_blocks(*nkr))
