"""Port parity: the §3 analysis (``repro_torch.core.analysis``) against the
JAX package's ``repro.core.analysis``, over the cases of
``tests/test_analysis.py``.

Fig. 3's rows come from the port's own repair plans and the MTTDL tables
from the same float arithmetic, so every value must be equal (``==``):
Table 1/2 rows, ``fig3_rows``, ``cross_rack_table`` and the §3.3
observations.
"""
import dataclasses

import pytest

from repro.core.analysis import bandwidth as rbw
from repro.core.analysis import reliability as rrel

from repro_torch.core.analysis import MTTDLModel, cross_rack_table, fig3_rows, table1_rows, \
    table2_rows
from repro_torch.core.analysis import bandwidth, reliability


def test_fig3_rows_equal_reference():
    got = [dataclasses.asdict(row) for row in fig3_rows()]
    want = [dataclasses.asdict(row) for row in rbw.fig3_rows()]
    assert got == want
    assert [row.label for row in fig3_rows()] == [row.label for row in rbw.fig3_rows()]


def test_cross_rack_table_and_observations_equal_reference():
    assert cross_rack_table() == rbw.cross_rack_table()
    assert bandwidth.paper_observations() == rbw.paper_observations()
    for row in fig3_rows():
        assert row.cross_rack_blocks == pytest.approx(row.closed_form), row.label


@pytest.mark.parametrize("gamma", [0.2, 1.0, 2.0])
def test_table1_equals_reference(gamma):
    assert table1_rows(gamma) == rrel.table1_rows(gamma)


@pytest.mark.parametrize("mttf", [2.0, 4.0, 10.0])
def test_table2_equals_reference(mttf):
    assert table2_rows(mttf) == rrel.table2_rows(mttf)


def test_paper_tables_and_models_equal_reference():
    assert reliability.PAPER_TABLE1 == rrel.PAPER_TABLE1
    assert reliability.PAPER_TABLE2 == rrel.PAPER_TABLE2
    for kwargs in ({}, {"r": 3, "c_single": 2.0}, {"r": 9, "c_single": 8 / 3, "lambda2": 0.005},
                   {"r": 3, "c_single": 2.0, "lambda2": 0.005, "gamma_gbps": 0.2},
                   {"n": 6, "k": 4, "r": 3, "c_single": 1.5, "c_multi": 3.0}):
        assert MTTDLModel(**kwargs).mttdl_years() == rrel.MTTDLModel(**kwargs).mttdl_years()


@pytest.mark.parametrize("key", list(reliability.PAPER_TABLE1))
def test_table1_matches_paper(key):
    for got, want in zip(table1_rows()[key], reliability.PAPER_TABLE1[key]):
        assert got == pytest.approx(want, rel=0.02)
