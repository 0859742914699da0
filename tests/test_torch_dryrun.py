"""The port's dry run (``launch.dryrun``) held to the reference and to hand
counts, on the CPU.

* ``input_specs`` and ``model_flops_global`` equal the reference's for all
  10 architectures x their applicable shapes (the reference's
  ``input_specs`` here, and ``model_flops_global``'s arithmetic on its own
  configs: importing ``repro.launch.dryrun`` sets 512 XLA devices, so
  ``tests/test_torch_dryrun_args.py`` calls it in a subprocess and holds it
  equal too);
* the :class:`~repro_torch.launch.dryrun.Meter` counts rank 0's local work:
  on a ``(1, 4)`` ``tp`` mesh of a fake group, a column-parallel product
  counts ``2·m·n·k / 4`` FLOP and a row-parallel one the same plus one
  all-reduce of the output's bytes (the hand count);
* the flash kernel's custom op on fake ``cuda`` tensors (no mesh): the
  output's shape and dtype, its FLOP count equal to ``chip_smoke.py``'s
  ``flash_flops`` formula, and no launch counted;
* on the production meshes, smoke cells' multi-pod peak is no more than the
  single-pod one (the reference's ``tests/test_artifacts.py`` bound);
* the CLI writes ``{arch}__{shape}__{mesh}__{rules}.json``, skips
  ``long_500k`` for full-attention archs, and ``launch.train --dryrun``
  defers to it; the orchestrator refuses ``artifacts/``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as rconfigs

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun, orchestrate_dryrun
from repro_torch.launch import train as launch_train
from repro_torch.models.config import SHAPES, ShapeConfig
from torch_groups import no_process_group_left  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


CELLS = [(arch, shape) for arch in tconfigs.ARCHS
         for shape in tconfigs.applicable_shapes(tconfigs.get_config(arch))]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_model_flops_equal_reference(arch, shape):
    want = rconfigs.input_specs(rconfigs.get_config(arch), shape)
    got = tconfigs.input_specs(tconfigs.get_config(arch), shape)
    assert got.keys() == want.keys()
    for key, spec in want.items():
        assert tuple(got[key].shape) == tuple(spec.shape), key
        assert str(got[key].dtype).removeprefix("torch.") == str(np.dtype(spec.dtype)), key
        assert got[key].device.type == "meta"
    rcfg, s = rconfigs.get_config(arch), SHAPES[shape]
    n = rcfg.active_params()
    ref = {"train": 6.0 * n * s.tokens, "prefill": 2.0 * n * s.tokens,
           "decode": 2.0 * n * s.global_batch}[s.kind]
    assert dryrun.model_flops_global(tconfigs.get_config(arch), s, s.kind) == ref


def test_meter_counts_rank0_local_work_by_hand():
    """Column- then row-parallel products over a (1, 4) tp mesh: each rank's
    share of 2·m·n·k, one all-reduce of the row-parallel output."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import shard_tensor
    from repro_torch.launch.mesh import fake_world, make_model_mesh

    b, s, d, f = 2, 8, 16, 32
    with fake_world(4, 0):
        mesh = make_model_mesh((1, 4), device_type="cpu")
        with FakeTensorMode() as fake:
            x = shard_tensor(torch.empty(b, s, d), mesh, (None, None, None))
            w1 = shard_tensor(torch.empty(d, f), mesh, (None, "model"))
            w2 = shard_tensor(torch.empty(f, d), mesh, ("model", None))
            with dryrun.Meter(fake) as meter:
                h = x @ w1
                assert h.placements[1] == Shard(2)
                y = (h @ w2).redistribute(mesh, [Replicate(), Replicate()])
                assert tuple(y.to_local().shape) == (b, s, d)
    assert meter.flops == 2 * (2 * b * s * d * f // 4)
    assert meter.coll_counts == {"all_reduce": 1}
    assert meter.coll_bytes == {"all_reduce": b * s * d * 4}


GUARD_CELL = ("starcoder2-3b", ShapeConfig("p", 64, 32, "prefill"), "tp", (2, 4))


def _measure_guard_cell():
    arch, shape, rules, mesh_shape = GUARD_CELL
    cfg = tconfigs.get_smoke(arch)
    return dryrun.measure_cell(cfg, shape, multi_pod=False, rules_mode=rules,
                               tcfg=dryrun.train_config(cfg), device="cpu",
                               mesh_shape=mesh_shape)


def test_measure_cell_refuses_to_run_beside_a_gloo_group(tmp_path):
    """The dry run's fake group never replaces a caller's group: beside a
    live 1-rank ``gloo`` group ``measure_cell`` raises, and the group is
    still there, still ``gloo``."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="'gloo' group of 1 ranks exists"):
            _measure_guard_cell()
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert torch.distributed.get_world_size() == 1
    finally:
        torch.distributed.destroy_process_group()


def test_measure_cell_leaves_no_process_group():
    """``measure_cell`` makes its fake group and takes it down; a second
    call, in a group made anew, counts the same work."""
    first = _measure_guard_cell()
    assert not torch.distributed.is_initialized()
    second = _measure_guard_cell()
    assert not torch.distributed.is_initialized()
    assert first["n_devices"] == second["n_devices"] == 8
    for key in ("argument_bytes", "peak_bytes", "output_bytes"):
        assert first[key] == second[key] > 0, key
    a, b = first["meter"], second["meter"]
    assert (a.flops, a.hbm_bytes, a.coll_bytes, a.coll_counts) == \
        (b.flops, b.hbm_bytes, b.coll_bytes, b.coll_counts)
    assert a.flops > 0 and a.coll_counts


def _flash_flops(b, sq, sk, h, d, causal):  # chip_smoke.py::flash_flops
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4 * b * h * d * pairs


@pytest.mark.parametrize("causal", [True, False])
def test_flash_custom_op_under_fake_cuda_tensors(causal):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import flash_attention, flops, rows_aligned

    before = flash_attention.launches
    with FakeTensorMode():
        q = torch.empty(2, 300, 8, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 200, 2, 64, dtype=torch.bfloat16, device="cuda")
        v = torch.empty(2, 200, 2, 64, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fc:
            out = flash_attention(q, k, v, causal=causal)
        assert tuple(out.shape) == (2, 300, 8, 64) and out.dtype == torch.bfloat16
        assert out.device.type == "cuda"
    with FakeTensorMode():  # alignment from the storage offset: a fake has no address
        flat = torch.empty(2 * 300 * 8 * 64 + 8, dtype=torch.bfloat16)
        assert rows_aligned(flat[8:].view(2, 300, 8, 64))
        assert not rows_aligned(flat[1:2 * 300 * 8 * 64 + 1].view(2, 300, 8, 64))
    want = _flash_flops(2, 300, 200, 8, 64, causal)
    assert fc.get_total_flops() == want == flops(2, 300, 200, 8, 64, causal)
    assert flash_attention.launches == before


SMOKE_CELLS = [("starcoder2-3b", ShapeConfig("t", 32, 64, "train"), "tp_sp"),
               ("starcoder2-3b", ShapeConfig("p", 64, 32, "prefill"), "tp"),
               ("dbrx-132b", ShapeConfig("d", 64, 32, "decode"), "fsdp")]


@pytest.mark.parametrize("arch,shape,rules", SMOKE_CELLS, ids=lambda x: getattr(x, "kind", x))
def test_multi_pod_never_needs_more_memory(arch, shape, rules):
    """Adding the pod axis shards, it does not replicate: multi-pod memory
    per device at most single-pod (the reference's bound, 5% + 0.1 GiB)."""
    cfg = tconfigs.get_smoke(arch)
    got = {mp: dryrun.run_cell(arch, shape.name, config=cfg, shape=shape, multi_pod=mp,
                               rules_mode=rules, device="cpu", verbose=False)
           for mp in (False, True)}
    for res in got.values():
        assert res["status"] == "ok" and res["kind"] == shape.kind
        assert res["memory"]["peak_bytes"] >= res["memory"]["argument_bytes"] > 0
        assert res["roofline"]["flops"] > 0
    assert got[False]["n_devices"] == 256 and got[True]["n_devices"] == 512
    s = got[False]["memory"]["peak_bytes"]
    m = got[True]["memory"]["peak_bytes"]
    assert m <= s * 1.05 + 0.1 * 2**30, (s, m)


def test_cli_artifact_skip_and_train_dryrun(tmp_path, monkeypatch):
    calls = []

    def fake_run_cell(arch, shape, **kw):
        calls.append((arch, shape, kw))
        return {"arch": arch, "shape": shape, "mesh": "multi" if kw["multi_pod"] else "single",
                "rules": kw["rules_mode"], "status": "ok"}

    res = dryrun.run_cell("starcoder2-3b", "long_500k", device="cpu")
    assert res["status"] == "skipped" and "long_500k" in res["reason"]
    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    assert dryrun.main(["--arch", "minicpm-2b", "--shape", "decode_32k", "--mesh", "multi",
                        "--rules", "tp", "--device", "cpu", "--out", str(tmp_path)]) == 0
    assert os.listdir(tmp_path) == ["minicpm-2b__decode_32k__multi__tp.json"]
    assert launch_train.main(["--arch", "dbrx_132b", "--dryrun", "--shape", "train_4k",
                              "--device", "cpu", "--out", str(tmp_path / "t")]) == 0
    assert calls[-1][0:2] == ("dbrx_132b", "train_4k")
    assert calls[-1][2]["rules_mode"] == "fsdp_sp"  # the orchestrator's cell rules
    with open(tmp_path / "t" / "dbrx_132b__train_4k__single__fsdp_sp.json") as f:
        assert json.load(f)["status"] == "ok"
    with pytest.raises(SystemExit, match="artifacts/"):
        orchestrate_dryrun.main(["--out", "artifacts/dryrun", "--arch", "minicpm_2b"])


def test_orchestrator_overrides_are_the_reference_s():
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "src", "repro", "launch", "orchestrate_dryrun.py")
    tree = ast.parse(open(path).read())
    ns: dict = {}
    for node in tree.body:  # the module's constant part, without its imports
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.For)):
            exec(compile(ast.Module([node], []), path, "exec"), ns)
    assert ns["OVERRIDES"] == orchestrate_dryrun.OVERRIDES
    for arch in tconfigs.ARCHS:
        for shape in SHAPES:
            cmd = orchestrate_dryrun.cell_cmd(arch, shape, "single", "out", "cpu")
            assert cmd[cmd.index("--rules") + 1] == orchestrate_dryrun.cell_rules(arch, shape)


def test_dryrun_decode_cell_counts_its_cache():
    """A decode cell's argument bytes hold the KV cache laid out over the
    mesh: StarCoder2-3B smoke's (L, B, S, kvH, hd) bf16 cache, its batch
    over data and its kv heads replicated over model (2 heads over 16)."""
    cfg = tconfigs.get_smoke("starcoder2-3b")
    shape = ShapeConfig("d", 128, 64, "decode")
    res = dryrun.run_cell("starcoder2-3b", "d", config=cfg, shape=shape, rules_mode="tp",
                          device="cpu", verbose=False)
    cache = 2 * cfg.n_layers * (64 // 16) * 128 * cfg.n_kv_heads * cfg.head_dim * 2
    assert res["memory"]["argument_bytes"] >= cache
    small = dryrun.run_cell("starcoder2-3b", "d", config=cfg,
                            shape=dataclasses.replace(shape, seq_len=64), rules_mode="tp",
                            device="cpu", verbose=False)
    assert res["memory"]["argument_bytes"] - small["memory"]["argument_bytes"] == cache // 2


def test_buffers_lists_the_largest_live_at_the_peak():
    """``launch.buffers``: the live storages at the step's peak, grouped by
    (dtype and shape, op), largest total first, none under ``min_bytes``,
    all of them within the peak's own bytes."""
    from repro_torch.launch import buffers

    cfg = tconfigs.get_smoke("starcoder2-3b")
    got = buffers.cell_buffers("starcoder2-3b", "t", config=cfg, shape=ShapeConfig(
        "t", 64, 16, "train"), rules_mode="fsdp", device="cpu", min_bytes=1024, top=50,
        mesh_shape=(2, 4))
    rows = got["buffers"]
    assert rows and all(r["bytes"] >= 1024 for r in rows)
    totals = [r["bytes"] * r["count"] for r in rows]
    assert totals == sorted(totals, reverse=True)
    assert sum(totals) <= got["peak_bytes"] - got["argument_bytes"]
    assert {"shape", "op", "gib", "count", "total_gib"} <= rows[0].keys()


def test_meter_counts_bmm_with_out_dtype():
    """The MoE's expert products on the card are ``aten::bmm.dtype`` (bf16 in,
    f32 out, ``models/mlp.py::_BmmF32``): counted as 2·b·m·k·n, the dtype
    argument kept away from the formula's output shape (on the card the
    dbrx and grok cells failed on it before)."""
    with FakeTensorMode() as fake:
        a = torch.empty(4, 8, 16, dtype=torch.bfloat16)
        b = torch.empty(4, 16, 32, dtype=torch.bfloat16)
        with dryrun.Meter(fake) as meter:
            y = torch.bmm(a, b, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    assert meter.flops == 2 * 4 * 8 * 16 * 32 and meter.flops_by_op == {"bmm": meter.flops}
