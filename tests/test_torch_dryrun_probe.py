"""The roofline probe's extrapolation (``launch.roofline_probe``) equals
the full-depth dry run's count, exactly, on a smoke config of each kind of
layer stack: a uniform stack (StarCoder2-3B smoke at 5 layers, a train step
under fsdp in 2 microbatches; dbrx smoke's MoE layers, a decode step),
zamba2's two block kinds (5 Mamba2 layers and the shared block every 2, a
train step under tp_sp), whisper's encoder and decoder (4 and 3 layers, a
prefill), and xlstm (run whole).  The counts compared are the FLOPs, the
HBM bytes and each collective kind's bytes, rank 0's on a (2, 4) mesh of a
``fake`` group, on the CPU's paths.
"""
import dataclasses

import pytest

from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch import roofline_probe as rp
from repro_torch.models.config import ShapeConfig
from torch_groups import no_process_group_left  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


CASES = [
    ("starcoder2-3b", dict(n_layers=5), ShapeConfig("t", 32, 16, "train"), "fsdp", 2),
    ("dbrx-132b", dict(n_layers=3), ShapeConfig("d", 32, 8, "decode"), "tp", 1),
    ("zamba2-1.2b", dict(n_layers=5, shared_attn_every=2), ShapeConfig("t", 32, 8, "train"),
     "tp_sp", 2),
    ("whisper-small", dict(n_layers=3, encoder_layers=4), ShapeConfig("p", 32, 8, "prefill"),
     "tp", 1),
    ("xlstm-125m", {}, ShapeConfig("t", 32, 8, "train"), "tp", 1),
]


@pytest.mark.parametrize("arch,cut,shape,rules,mb", CASES, ids=[c[0] for c in CASES])
def test_probe_extrapolation_equals_full_depth(arch, cut, shape, rules, mb):
    cfg = dataclasses.replace(get_smoke(arch), **cut)
    plan = rp.probe_plan(cfg)
    assert sum(w for w, _ in plan) == 1  # the weights of an affine combination
    assert all(probe.n_layers <= 2 for _, probe in plan) or cfg.family == "ssm"
    est = rp.true_costs(arch, shape.name, rules, mb, config=cfg, shape=shape, device="cpu",
                        mesh_shape=(2, 4))
    full = rp._vector(dryrun.measure_cell(
        cfg, shape, multi_pod=False, rules_mode=rules, mesh_shape=(2, 4), device="cpu",
        tcfg=dryrun.train_config(cfg, microbatches=mb))["meter"])
    assert est == full
    assert est["flops"] > 0 and est["bytes"] > 0


def test_probe_roofline_fields():
    cfg = get_smoke("starcoder2-3b")
    shape = ShapeConfig("t", 32, 16, "train")
    costs = {"flops": 2_000_000, "bytes": 3_000_000, "coll_all_gather": 10, "coll_all_reduce": 5,
             "coll_reduce_scatter": 0, "coll_all_to_all": 0}
    roof = rp.roofline_terms(cfg, shape, costs, 8)
    assert roof["collective_bytes"] == 15 and roof["collective_by_op"]["all_gather"] == 10
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert roof[f"{roof['bottleneck']}_s"] == max(roof["compute_s"], roof["memory_s"],
                                                 roof["collective_s"])
    assert roof["useful_flops_ratio"] == roof["model_flops"] / 2_000_000
    assert rp.cell_microbatches("dbrx_132b", "train_4k") == 8
    assert rp.cell_microbatches("starcoder2_3b", "train_4k") == 1
