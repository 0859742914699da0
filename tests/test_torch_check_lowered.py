"""The port's lowered-layer analyzer (``repro_torch.check.lowered``).

* ``spmd-schedule`` and ``shard-rules``: the port's records equal the
  reference's (``repro.check.lowered``), finding by finding, and so do the
  findings of every mutated artifact;
* ``cuda-kernel``: the launch-geometry sweep passes at every shape, the
  GF sources are dtype-clean, and the interval-based ``out-alias`` rule
  agrees with a byte-by-byte (row-by-row) brute force of the kernels' work
  walk at tiny shapes, clean and mutated;
* ``self_test_lowered()``: every mutation FAILs its owning rule and no other.

The reference is called in process (never through its CLI).
"""
import numpy as np
import pytest
import torch

from repro.check.lowered import shard_rules as rshard
from repro.check.lowered import spmd as rspmd
from repro.configs import get_config as rget_config
from repro.core.codes.registry import make_code as rmake_code
from repro.dist import sharding as rsharding
from repro.dist.collectives import plan_to_spmd as rplan_to_spmd

from repro_torch.check import lowered as tlowered
from repro_torch.check.lowered import cuda, shard_rules as tshard, spmd as tspmd
from repro_torch.check.report import FAIL
from repro_torch.configs import ARCHS, get_config as tget_config
from repro_torch.core.codes.registry import make_code as tmake_code
from repro_torch.dist import sharding as tsharding
from repro_torch.dist.collectives import plan_to_spmd as tplan_to_spmd
from repro_torch.kernels import gf_matmul as gk
from repro_torch.kernels.flash_attention import flash_attention_work_geometry
from repro_torch.kernels.gf_matmul import gf_matmul_geometry

SPMD_CODES = tlowered.LOWERED_SWEEP["spmd-schedule"]


def _finding(f):
    d = f.as_dict()
    del d["message"]  # prose; the rule, severity and witness are the contract
    return d


def _record(rec):
    d = rec.as_dict()
    d["findings"] = [_finding(f) for f in rec.findings]
    return d


# ------------------------------------------------------------------ spmd
@pytest.mark.parametrize("fam,n,k,r", SPMD_CODES)
def test_spmd_records_equal_the_reference_s(fam, n, k, r):
    got = tspmd.verify_spmd_lowering(tmake_code(fam, n, k, r=r))
    want = rspmd.verify_spmd_lowering(rmake_code(fam, n, k, r=r))
    assert [_record(g) for g in got] == [_record(w) for w in want]
    assert all(g.status != FAIL for g in got)


@pytest.mark.parametrize("mutation", list(rspmd.SPMD_MUTATIONS))
def test_mutated_spmd_findings_equal_the_reference_s(mutation):
    found = []
    for make, lower, mod in ((tmake_code, tplan_to_spmd, tspmd),
                             (rmake_code, rplan_to_spmd, rspmd)):
        code = make("DRC", 6, 4, r=3)
        plan = code.repair_plan(0)
        mutated = mod.mutate_spmd(code, plan, lower(code, plan), mutation)
        found.append([_finding(f) for f in mod.spmd_mutation_findings(code, plan, mutated)])
    assert found[0] == found[1]
    assert {f["rule"] for f in found[0] if f["severity"] == FAIL} == {
        tspmd.SPMD_MUTATIONS[mutation]}


# ----------------------------------------------------------- shard rules
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_records_equal_the_reference_s(arch):
    assert tsharding.MODES == rsharding.MODES
    for mode in tsharding.MODES:
        got = tshard.verify_shard_rules(tget_config(arch), mode)
        want = rshard.verify_shard_rules(rget_config(arch), mode)
        assert _record(got) == _record(want)
        assert got.status != FAIL


@pytest.mark.parametrize("mutation", list(rshard.SHARD_MUTATIONS))
def test_mutated_shard_findings_equal_the_reference_s(mutation):
    found = []
    for mod, sh, get in ((tshard, tsharding, tget_config), (rshard, rsharding, rget_config)):
        art = mod.ShardArtifact(
            rules=sh.make_rules("tp", multi_pod=True), config=get("command_r_35b"),
            meshes=(*mod.MULTI_POD_MESHES, *mod.CANONICAL_MESHES), resolver=sh.resolve_spec)
        found.append([_finding(f) for f in mod.analyze_shard_artifact(
            mod.mutate_shard(art, mutation))])
    # a spec entry is a tuple in the port and a PartitionSpec entry in the
    # reference: both serialize to the same lists
    assert found[0] == found[1]


# ------------------------------------------------------------ the sweep
def test_sweep_counts_and_baseline():
    records = tlowered.run_lowered_sweep()
    by_family = {}
    for rec in records:
        by_family[rec.family] = by_family.get(rec.family, 0) + 1
    assert by_family["spmd-schedule"] == 46
    assert by_family["shard-rules"] == 50
    assert by_family["cuda-kernel"] >= 12
    assert all(rec.status != FAIL for rec in records)
    import json
    from repro_torch.check.__main__ import BASELINE
    assert len(records) >= json.load(open(BASELINE))["min_lowered_records"]


GEOMETRIES = cuda.sweep_geometries()


@pytest.mark.parametrize("label,geom", GEOMETRIES, ids=[label for label, _ in GEOMETRIES])
def test_cuda_sweep_passes(label, geom):
    rec = cuda.verify_kernel_geometry(label, geom)
    assert rec.findings == [], [f.message for f in rec.findings]


def test_cuda_sweep_covers_the_main_path_shapes():
    gf = {label: g for label, g in GEOMETRIES if hasattr(g, "tile_bytes")}
    assert len(gf) == 10 and len(GEOMETRIES) - len(gf) == 8
    assert gf["DRC(9,6,3) encode"].b == 22_369_664  # 64 MiB over alpha 3, 128-aligned
    assert any(g.passes > 1 for g in gf.values())
    assert any(g.b % 16 for g in gf.values())
    flash = [g for _, g in GEOMETRIES if not hasattr(g, "tile_bytes")]
    assert max(g.items for g in flash) == 3072  # the StarCoder2-3B prefill
    assert {g.bf16 for g in flash} == {True, False}
    assert any(g.sq == 1 for g in flash) and any(g.sq % 128 for g in flash)


@pytest.mark.parametrize("path", cuda.gf_source_paths())
def test_gf_sources_are_dtype_clean(path):
    assert cuda.verify_gf_source(path).findings == []


# ------------------------------------------------------------- self-test
@pytest.mark.parametrize("row", tlowered.self_test_lowered(), ids=lambda row: row[0])
def test_every_lowered_mutation_fails_exactly_its_owner(row):
    mutation, owner, caught, exclusive = row
    assert caught and exclusive, (mutation, owner)


def test_lowered_catalog_keeps_the_reference_s_spmd_and_shard_rows():
    from repro.check.lowered import LOWERED_MUTATIONS as RMUT

    port = tlowered.LOWERED_MUTATIONS
    for mutation, (family, owner) in RMUT.items():
        if family != "pallas-kernel":
            assert port[mutation] == (family, owner)
    assert {m for m, (fam, _) in port.items() if fam == "cuda-kernel"} == {
        "cuda_oob_tile", "cuda_oob_kv_head", "cuda_alias_out", "gf_xor_as_add",
        "gf_uint8_index"}


# -------------------------------------------- interval rule vs brute force
def _gf_counts(geom):
    """Writes per (row, byte) of one batch row, lane by lane and byte by
    byte, from the walk: block bx's items bx, bx + grid_x, ..; lane l of a
    column warp stores bytes [16l, 16l + 16) and [512 + 16l, ..) of its
    slice; bytes at or past B are masked."""
    counts = np.zeros((geom.r, geom.b), dtype=np.int64)
    for bx in range(geom.grid_x):
        for item in range(bx, geom.items, geom.grid_x):
            tile, p = (int(v[0]) for v in geom.place(np.array([item])))
            for w in range(geom.wr):
                lo, n = (int(v) for v in geom.warp_rows(p, w))
                for c in range(geom.wc):
                    for lane in range(32):
                        for half in range(2):
                            col = (tile * geom.tile_bytes + c * gk.SLICE_BYTES
                                   + half * gk.HALF + lane * 16)
                            for byte in range(col, col + 16):
                                if 0 <= byte < geom.b:
                                    counts[max(lo, 0):lo + n, byte] += 1
    return counts


def _flash_counts(geom):
    """Writes per (b, row, h) of the output, item by item and row by row."""
    counts = np.zeros((geom.b, geom.sq, geom.h), dtype=np.int64)
    blocks = range(geom.grid_x * geom.grid_y)
    for blk in blocks:
        visits = range(blk, geom.items, geom.grid_x) if geom.bf16 else [blk]
        for item in visits:
            at = {k: int(v[0]) for k, v in geom.place(np.array([item])).items()}
            for lo, hi in geom.store_rows(np.array([at["q0"]])):
                for row in range(int(lo[0]), int(hi[0])):
                    if 0 <= row < geom.sq and 0 <= at["b"] < geom.b and 0 <= at["h"] < geom.h:
                        counts[at["b"], row, at["h"]] += 1
    return counts


def _alias_fails(geom):
    return any(f.severity == FAIL for f in cuda.check_cuda_out_alias(geom))


GF_TINY = [(1, 3, 6, 17), (2, 13, 1, 1000), (1, 150, 3, 2100)]
FLASH_TINY = [((1, 100, 77, 4, 2, 128, True), torch.bfloat16),
              ((2, 77, 130, 6, 3, 32, False), torch.float32),
              ((1, 192, 192, 4, 2, 32, True), torch.bfloat16)]


def _gf_variants(shape):
    geom = gf_matmul_geometry(*shape, sms=4)
    flash = flash_attention_work_geometry(1, 100, 77, 4, 2, 128, torch.bfloat16, 4)
    out = [("clean", geom)]
    for mutation in ("cuda_alias_out", "cuda_oob_tile"):
        if mutation == "cuda_alias_out" and geom.items < 2:
            continue
        out.append((mutation, cuda.mutate_cuda(geom, flash, {}, mutation)[0]))
    return out


@pytest.mark.parametrize("shape", GF_TINY)
def test_gf_interval_alias_agrees_with_brute_force(shape):
    variants = _gf_variants(shape)
    assert variants[0][1].passes > 1 or shape != GF_TINY[2]
    for name, geom in variants:
        exact = bool((_gf_counts(geom) == 1).all())
        assert _alias_fails(geom) == (not exact), name
        assert exact == (name != "cuda_alias_out"), name


@pytest.mark.parametrize("shape,dtype", FLASH_TINY)
def test_flash_interval_alias_agrees_with_brute_force(shape, dtype):
    b, sq, sk, h, kvh, d, causal = shape
    geom = flash_attention_work_geometry(b, sq, sk, h, kvh, d, dtype, 5, causal=causal)
    base = type(geom).place

    def doubled(self, item):  # item 1 writes item 0's rows too
        at = base(self, item)
        first = base(self, np.zeros_like(item))
        return {key: np.where(item == 1, first[key], v) for key, v in at.items()}

    for name, g in (("clean", geom), ("alias", cuda._mutant(geom, place=doubled))):
        exact = bool((_flash_counts(g) == 1).all())
        assert _alias_fails(g) == (not exact), name
        assert exact == (name == "clean"), name


# ---------------------------------------------------------- the models
def test_gf_geometry_model_refuses_what_the_source_refuses():
    with pytest.raises(ValueError):
        gf_matmul_geometry(65_536, 1, 1, 16, sms=132)
    with pytest.raises(ValueError):
        gf_matmul_geometry(1, 0, 1, 16, sms=132)
    with pytest.raises(ValueError):
        flash_attention_work_geometry(300, 8, 8, 256, 1, 64, torch.float32, 132)


def test_gf_geometry_model_widens_narrow_products_and_splits_tall_ones():
    narrow = gf_matmul_geometry(1, 9, 18, 65_536, sms=132)
    assert narrow.wr == 16 and narrow.tile_bytes == 1024 and narrow.tiles == 64
    tall = gf_matmul_geometry(1, 200, 8, 5_008, sms=132)
    assert tall.passes == 2 and tall.rows_per_pass == 100
    batched = gf_matmul_geometry(9, 3, 3, 22_369_664, sms=132)
    assert batched.grid_x == 132 // 9
