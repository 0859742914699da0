"""The port's traced-layer analyzer (``repro_torch.check.traced``).

* the sweep: 15 op-trace records of the port's entry points (the
  process-group repair over every rank of a fake ``(pod, node)`` world at
  nine shapes, both GF paths, the xlstm serve and train steps, the
  checkpoint encode), all PASS, every kind covered, at the committed floor;
* ``self_test_traced()``: each of the 9 mutations FAILs its owning rule and
  no other;
* each rule on small programs and their clean twins, and hypothesis over the
  pure send matcher;
* for every repair shape the bytes the traced collector receives across pods
  equal ``traffic_blocks()·alpha·sub``, Eq. (3) for DRC, and the reference's
  compiled-HLO bytes (``repro.launch.hlo_analysis.cross_pod_permute_bytes``
  of the jitted ``shard_map`` program, in one subprocess with 16 XLA host
  devices: the reference's traced layer itself does not run on this jax);
* the capture's fake world refuses to start beside a ``gloo`` group.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch.check import traced
from repro_torch.check.report import CheckReport, TracedRecord
from repro_torch.check.traced import capture as tcap
from repro_torch.check.traced import collectives as tcoll
from repro_torch.check.traced import dtype_flow as tdtype
from repro_torch.check.traced import hygiene as thyg
from repro_torch.core.codes import make_code
from repro_torch.core.gf_torch import gf_matmul_table
from repro_torch.kernels import ops
from repro_torch.kernels.gf_matmul import gf_matmul_batched

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - env without hypothesis
    HAVE_HYPOTHESIS = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SHAPES = traced.spmd_shapes()
LABELS = [f"spmd_repair[{f}({n},{k},{r}) failed=0]" for f, n, k, r in SHAPES] + [
    "gf_matmul_table[3x6x256]", "gf_matmul_cuda[3x6x1024]", "prefill_step[xlstm-smoke]",
    "serve_step[xlstm-smoke]", "train_step[xlstm-smoke]", "ckpt_encode[DRC(6,4,3) sub=256]"]


@pytest.fixture(scope="module")
def programs():
    return {p.name: p for p in traced.sweep_programs()}


@pytest.fixture(scope="module")
def records(programs):
    return {name: traced.record(p) for name, p in programs.items()}


@pytest.fixture(scope="module")
def self_test_rows():
    return {row[0]: row for row in traced.self_test_traced()}


# ------------------------------------------------------------------ sweep
def test_sweep_gives_15_records_of_every_kind_at_the_baseline(records):
    assert list(records) == LABELS
    kinds = [r.kind for r in records.values()]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "repair": 9, "kernel": 2, "hot-path": 3, "checkpoint": 1}
    floor = json.load(open(os.path.join(SRC, "repro_torch/check/traced_baseline.json")))
    assert len(records) >= floor["min_traced_records"] == 15
    assert CheckReport(traced_records=list(records.values())).ok


@pytest.mark.parametrize("label", LABELS)
def test_traced_record_passes_every_rule(records, label):
    rec = records[label]
    assert rec.status == "PASS", [f.message for f in rec.findings]
    assert rec.info["rules_checked"] == 9 == len(traced.TRACED_RULES)
    assert rec.info["ops"] > 0


@pytest.mark.parametrize("fam,n,k,r", SHAPES)
def test_repair_trace_is_every_rank_s_body(programs, fam, n, k, r):
    p = programs[f"spmd_repair[{fam}({n},{k},{r}) failed=0]"]
    spec = p.meta["spec"]
    world = spec.r * spec.w
    assert sorted({op.rank for op in p.ops}) == list(range(world))
    # one node all-gather a rank, inside its pod; the collector alone receives
    assert sorted(g.rank for g in p.footprint.gathers) == list(range(world))
    assert all(len(g.group) == spec.w for g in p.footprint.gathers)
    assert {q.rank for q in p.footprint.recvs} == {spec.target_pod * spec.w}
    # every rank ran the GF kernel's custom op on fake card tensors
    gf = [op for op in p.ops if op.name == "repro_torch.gf_matmul.default"]
    assert {op.rank for op in gf} == set(range(world))
    assert all(t.device == "cuda" for op in gf for t in op.inputs)
    assert [(d.dtype, d.shape) for d in p.donated] == [("uint8", (1, spec.alpha, 256))] * world


def test_hot_paths_run_on_fake_card_tensors(programs):
    for name in ("prefill_step[xlstm-smoke]", "serve_step[xlstm-smoke]"):
        devices = {t.device for op in programs[name].ops for t in op.inputs}
        assert devices <= {"cuda", "cpu"} and "cuda" in devices
    train = programs["train_step[xlstm-smoke]"]
    assert train.meta["device"] == tcap.train_device()
    assert any("mm" in op.name for op in train.ops)  # forward and backward products


# -------------------------------------------------------------- self-test
@pytest.mark.parametrize("mutation", list(traced.TRACED_MUTATIONS))
def test_self_test_catches_each_mutation_by_its_owner_alone(self_test_rows, mutation):
    _, owner, caught, exclusive = self_test_rows[mutation]
    assert owner == traced.TRACED_MUTATIONS[mutation][1]
    assert caught and exclusive


def test_mutation_and_rule_ids_are_the_reference_s():
    assert sorted(traced.TRACED_RULES) == sorted([
        "traced.dtype.wrap-arith", "traced.dtype.promotion", "traced.dtype.payload-output",
        "traced.coll.pairing", "traced.coll.permute-match", "traced.coll.axis-scope",
        "traced.coll.cross-bytes", "traced.hyg.host-transfer", "traced.hyg.donation"])
    assert list(traced.TRACED_MUTATIONS) == [
        "dtype_wrap_arith", "dtype_float_promote", "dtype_narrow_output",
        "coll_orphan_permute", "coll_self_send", "coll_axis_scope", "coll_hlo_bytes",
        "hyg_callback", "hyg_no_donation"]


# ------------------------------------------------------------ dtype flow
def _cpu_program(fn, *args, payload_outvars=(0,)):
    return tcap.capture_call("t", tcap.KERNEL, fn, args, fake=False,
                             payload_invars=tuple(range(len(args))),
                             payload_outvars=payload_outvars)


def _u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


def test_gf_matmul_table_is_taint_clean():
    p = tcap.capture_gf_table()
    assert tdtype.dtype_flow_violations(p) == []
    assert any(op.base == "index" for op in p.ops)  # the table lookups carry taint
    assert any(op.name == "aten.bitwise_xor_.Tensor" for op in p.ops)


@pytest.mark.parametrize("fn,kind", [
    (lambda m, x: gf_matmul_table(m, x) + 1, "wrap-arith"),
    (lambda m, x: gf_matmul_table(m, x) * gf_matmul_table(m, x), "wrap-arith"),
    (lambda m, x: gf_matmul_table(m, x).sum(0, dtype=torch.uint8), "wrap-arith"),
    (lambda m, x: gf_matmul_table(m, x[:, :128].view(6, 128)).cumsum(1).to(torch.uint8),
     "wrap-arith"),
    (lambda m, x: gf_matmul_table(m, x.to(torch.bfloat16).to(torch.uint8)), "promotion"),
    (lambda m, x: torch.empty(6, 256).copy_(x), "promotion"),
])
def test_dtype_flow_flags_each_hazard(fn, kind):
    p = _cpu_program(fn, _u8(3, 6), _u8(6, 256), payload_outvars=())
    assert [v.kind for v in tdtype.dtype_flow_violations(p)] == [kind]


@pytest.mark.parametrize("fn", [
    lambda m, x: gf_matmul_table(m, x) ^ gf_matmul_table(m, x),  # GF addition is XOR
    lambda m, x: gf_matmul_table(m, x[:, ::2].contiguous()),  # views and copies
    lambda m, x: (x.long() + 1).to(torch.uint8),  # the sanctioned exit, then clean bytes
    lambda m, x: torch.zeros(6, 256, dtype=torch.uint8).copy_(x) & 0x0F,
])
def test_dtype_flow_is_quiet_on_clean_twins(fn):
    assert tdtype.dtype_flow_violations(_cpu_program(fn, _u8(3, 6), _u8(6, 256))) == []


def test_taint_follows_the_storage_through_views_and_in_place_writes():
    def fn(x):
        buf = torch.zeros(8, 16, dtype=torch.uint8)
        buf[2:4] ^= x  # taint enters a view of a clean buffer
        return buf[0] + 1  # another view of the same storage: tainted

    p = _cpu_program(fn, _u8(2, 16))
    assert [v.kind for v in tdtype.dtype_flow_violations(p)] == ["wrap-arith"]


def test_taint_flows_through_the_gf_custom_op_on_fake_card_tensors():
    def fn(m, x, out):
        ops.gf_matmul(m, x, out=out)
        return out - out  # the kernel's output holds payload bytes

    with tcap.fake_cuda(), tcap.fake_mode():
        m, x = (torch.empty(s, dtype=torch.uint8, device="cuda") for s in ((3, 6), (6, 64)))
        out = torch.empty((3, 64), dtype=torch.uint8, device="cuda")
        p = tcap.capture_call("t", tcap.KERNEL, fn, (m, x, out), fake=True,
                              payload_invars=(1,))
    assert [op.name for op in p.ops].count("repro_torch.gf_matmul.default") == 1
    assert [v.kind for v in tdtype.dtype_flow_violations(p)] == ["wrap-arith"]


def test_payload_output_reads_the_declared_outputs():
    p = _cpu_program(lambda m, x: (gf_matmul_table(m, x), gf_matmul_table(m, x).long()),
                     _u8(3, 6), _u8(6, 256), payload_outvars=(0,))
    assert tdtype.check_payload_output(p) == []
    p = dataclasses.replace(p, payload_outvars=(1,))
    assert [f.witness["dtype"] for f in tdtype.check_payload_output(p)] == ["int64"]


# ------------------------------------------------------------ collectives
def _p2p(rank, peer, rows=1):
    return tcap.P2POp(rank=rank, peer=peer, rows=rows, nbytes=rows * 256, dtype="uint8")


def test_validate_p2p_reports_each_defect():
    assert tcoll.validate_p2p((_p2p(3, 0),), (_p2p(0, 3),), 9) == []
    assert "outside [0, 9)" in tcoll.validate_p2p((_p2p(3, 9),), (), 9)[0]
    assert "self-send" in tcoll.validate_p2p((_p2p(3, 3),), (), 9)[0]
    assert "repeated 2 times" in tcoll.validate_p2p((_p2p(3, 0), _p2p(3, 0)), (), 9)[0]
    assert "repeated 2 times" in tcoll.validate_p2p((), (_p2p(0, 3), _p2p(0, 3)), 9)[0]


def test_match_sends_sums_a_pod_s_sends_and_pairs_by_rank():
    steps = ((0, 0, (0, 1)), (1, 0, (0, 1, 2)), (2, 0, (5,)))
    sends = (_p2p(3, 0, 2), _p2p(4, 0, 1), _p2p(6, 0, 1), _p2p(1, 0, 1))  # 1 -> 0: intra-pod
    recvs = (_p2p(0, 3, 2), _p2p(0, 4, 1), _p2p(0, 6, 1), _p2p(0, 1, 1))
    m = tcoll.match_sends(sends, recvs, steps, 3)
    assert m.complete and m.matched == (((1, 0), 1), ((2, 0), 2))
    m = tcoll.match_sends(sends[1:], recvs, steps, 3)
    assert m.orphan_sends == ((1, 0, 1),) and m.orphan_steps == (1,)
    assert m.unpaired == (("recv", 0, 3),)
    # paired by rank, not by size: a receive of another size still pairs
    m = tcoll.match_sends(sends, (_p2p(0, 3, 9), *recvs[1:]), steps, 3)
    assert m.complete


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(r=st.integers(2, 5), w=st.integers(1, 5), target=st.integers(0, 4),
           units=st.lists(st.integers(0, 6), min_size=5, max_size=5),
           drop=st.integers(0, 30))
    def test_match_sends_is_complete_exactly_when_every_step_ships(r, w, target, units,
                                                                   drop):
        target %= r
        collector = target * w
        steps = tuple((q, target, tuple(range(units[q]))) for q in range(r) if units[q])
        sends, recvs = [], []
        for q, _, rows in steps:
            if q == target:
                continue
            # a pod's rows split over its nodes, each node one message
            left, j = len(rows), 0
            while left:
                take = min(left, 1 + j)
                sends.append(_p2p(q * w + j % w, collector, take))
                recvs.append(_p2p(collector, q * w + j % w, take))
                left, j = left - take, j + 1
        if tcoll.validate_p2p(tuple(sends), tuple(recvs), r * w):
            return  # a node would send twice: not a schedule the executor makes
        m = tcoll.match_sends(tuple(sends), tuple(recvs), steps, w)
        assert m.complete
        if sends:
            i = drop % len(sends)
            m = tcoll.match_sends(tuple(sends[:i] + sends[i + 1:]), tuple(recvs), steps, w)
            assert not m.complete and m.unpaired == (("recv", collector, sends[i].rank),)


def test_axis_scope_flags_a_pod_spanning_gather_and_a_ship_past_the_collector(programs):
    base = programs["spmd_repair[DRC(9,6,3) failed=0]"]
    fp = base.footprint
    bad = dataclasses.replace(base, footprint=dataclasses.replace(
        fp, reduces=(tcap.GroupOp(rank=1, name="allreduce_", group=(1, 4)),)))
    assert [f.witness["pods"] for f in tcoll.check_axis_scope(bad)] == [[0, 1]]
    wrong = dataclasses.replace(fp.sends[0], peer=1)  # pod 1 -> rank 1, not the collector
    bad = dataclasses.replace(base, footprint=dataclasses.replace(
        fp, sends=(wrong, *fp.sends[1:])))
    assert [(f.witness["src"], f.witness["dst"]) for f in tcoll.check_axis_scope(bad)] == [
        (wrong.rank, 1)]


@pytest.fixture(scope="module")
def reference_hlo_bytes():
    code = textwrap.dedent(f"""
        import json
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.core.codes import make_code
        from repro.dist.collectives import make_spmd_repair, plan_to_spmd
        from repro.launch.hlo_analysis import cross_pod_permute_bytes
        out = {{}}
        for fam, n, k, r in {SHAPES!r}:
            code = make_code(fam, n, k, r=r)
            spec = plan_to_spmd(code, code.repair_plan(0))
            mesh = jax.make_mesh((spec.r, spec.w), ("pod", "node"))
            fn = jax.shard_map(make_spmd_repair(spec), mesh=mesh,
                               in_specs=P(("pod", "node")), out_specs=P(("pod", "node")))
            x = jax.ShapeDtypeStruct((n, spec.alpha, 256), jnp.uint8)
            hlo = jax.jit(fn, donate_argnums=0).lower(x).compile().as_text()
            out[f"{{fam}}({{n}},{{k}},{{r}})"] = cross_pod_permute_bytes(hlo, spec.w)
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fam,n,k,r", SHAPES)
def test_traced_cross_bytes_equal_plan_eq3_and_reference_hlo(programs, records,
                                                             reference_hlo_bytes,
                                                             fam, n, k, r):
    from repro_torch.core.code_base import drc_min_cross_rack_blocks

    label = f"spmd_repair[{fam}({n},{k},{r}) failed=0]"
    p = programs[label]
    got = records[label].info["traced_cross_bytes"]
    plan, spec = p.meta["plan"], p.meta["spec"]
    assert got == round(plan.traffic_blocks()["cross_rack_blocks"] * plan.alpha) * 256
    assert got == spec.cross_units * 256 == reference_hlo_bytes[f"{fam}({n},{k},{r})"]
    if fam == "DRC":
        assert got == round(drc_min_cross_rack_blocks(n, k, r) * plan.alpha) * 256
    assert tcoll.check_cross_bytes(p) == []


# ---------------------------------------------------------------- hygiene
def test_host_transfer_fails_device_reads_and_copies_to_the_host_only():
    def step(x):
        y = (x * 2).sum()
        host = y.cpu()  # a device-to-host copy
        flag = bool(y > 0)  # a host read of a device value
        w = torch.ones(4).to("cuda")  # host to device: counted, not failed
        return x + w.sum() + host.to("cuda") * flag

    with tcap.fake_cuda(), tcap.fake_mode():
        x = torch.empty(4, device="cuda")
        p = tcap.capture_call("t", tcap.HOT_PATH, step, (x,), fake=True)
    moved = thyg.host_transfers(p)
    assert moved["host_reads"] == {"aten._local_scalar_dense.default": 1}
    assert moved["device_to_host"] == 1 and moved["host_to_device"] == 2
    assert len(thyg.check_host_transfer(p)) == 2
    # the same reads of host values are not device reads
    p = tcap.capture_call("t", tcap.HOT_PATH, lambda x: x.sum().item() + x, (torch.ones(3),),
                          fake=False)
    assert thyg.check_host_transfer(p) == []


def test_donation_accepts_compute_into_and_flags_a_staged_copy():
    def zeroed(out):
        out.zero_()
        return out

    def staged(out):
        tmp = torch.ones(8, 8, dtype=torch.uint8)
        out[:4].fill_(0)
        out.copy_(tmp)
        return out

    def small(out):
        out.zero_()
        out[:1].copy_(torch.ones(1, 8, dtype=torch.uint8))  # rows, not the region
        out[4:].copy_(torch.ones(1, 8, dtype=torch.uint8).expand(4, 8))
        return out

    def never(out):
        return out + 0

    got = {}
    for fn in (zeroed, staged, small, never):
        p = tcap.capture_call("t", tcap.CHECKPOINT, fn, (_u8(8, 8),), fake=False,
                              donated=(0,))
        got[fn.__name__] = [f.witness.get("temporary_bytes") for f in thyg.check_donation(p)]
    assert got == {"zeroed": [], "staged": [64], "small": [], "never": [None]}


def test_encode_is_handed_its_parity_rows():
    p = tcap.capture_checkpoint_encode()
    code = p.meta["code"]
    (region,) = p.donated
    assert region.key == p.inputs[0].key
    assert region.shape == ((code.n - code.k) * code.alpha, 256)
    bad = thyg.donation_mutation_program()
    assert [f.witness.get("temporary_bytes") for f in thyg.check_donation(bad)] == [
        region.nbytes, None]


# ------------------------------------------------------------ the capture
def test_capture_keys_storages_across_views():
    def fn(x):
        v = x[1:]
        v.zero_()
        return x.view(-1)

    x = _u8(4, 4)
    p = tcap.capture_call("t", tcap.KERNEL, fn, (x,), fake=False)
    keys = {t.key for op in p.ops for t in (*op.inputs, *op.outputs)}
    assert keys == {p.inputs[0].key} and p.outputs[0].key == p.inputs[0].key
    assert [op.view for op in p.ops] == [True, False, True]


def test_fake_world_refuses_to_start_beside_a_gloo_group():
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            with pytest.raises(RuntimeError, match="'gloo' group of 1 ranks exists"):
                with traced.fake_world(9, 0):
                    pass
            with pytest.raises(RuntimeError, match="gloo"):
                tcap.capture_spmd_repair("DRC", 6, 4, 3)
            assert dist.is_initialized() and dist.get_backend() == "gloo"
        finally:
            dist.destroy_process_group()


def test_fake_world_destroys_only_what_it_made():
    assert not dist.is_initialized()
    with traced.fake_world(6, 4):
        assert (dist.get_backend(), dist.get_rank(), dist.get_world_size()) == ("fake", 4, 6)
    assert not dist.is_initialized()


def test_fake_capture_launches_nothing_and_leaves_no_fake_tensor_cached():
    from repro_torch.train import checkpoint

    before = gf_matmul_batched.launches
    tcap.capture_checkpoint_encode()
    tcap.capture_gf_cuda()
    assert gf_matmul_batched.launches == before
    assert not any("cuda" in key[2] for key in checkpoint._ENCODE_STEPS)
    assert all(not torch._subclasses.fake_tensor.is_fake(t) for t in
               [ops._matrix_cached(b"\x01" * 4, (2, 2), torch.device("cpu"))])


# ------------------------------------------------------------------ CLI
def _cli(*args):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", "repro_torch.check", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_cli_traced_only_meets_its_baseline(tmp_path):
    out = tmp_path / "traced.json"
    proc = _cli("--traced-only", "--baseline", "src/repro_torch/check/traced_baseline.json",
                "--json", str(out))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "baseline OK: 15 traced record(s) >= floor 15" in proc.stdout
    for kind, n in (("checkpoint", 1), ("hot-path", 3), ("kernel", 2), ("repair", 9)):
        assert f"{kind:<16} {n:>7}  PASS" in proc.stdout
    report = json.loads(out.read_text())
    assert [r["label"] for r in report["traced_records"]] == LABELS
    assert report["plan_records"] == [] and report["lowered_records"] == []
    assert report["summary"] == {"PASS": 15, "WARN": 0, "FAIL": 0}


def test_traced_baseline_regression_fails(capsys, tmp_path):
    from repro_torch.check.__main__ import check_baseline, summary

    floor = tmp_path / "floor.json"
    floor.write_text(json.dumps({"min_traced_records": 2, "min_lowered_records": 0}))
    report = CheckReport(traced_records=[TracedRecord("x", "kernel")])
    assert check_baseline(report, floor, ("traced",)) == 1
    assert "BASELINE REGRESSION: traced sweep" in capsys.readouterr().out
    report.traced_records *= 2
    assert check_baseline(report, floor) == 0
    assert summary(report) == {"traced kernel": {"PASS": 2}}
