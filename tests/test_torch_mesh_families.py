"""Port parity: the ssm, hybrid, vlm and audio families' forward over a mesh.

The reference runs in a subprocess with 8 XLA CPU devices
(``mesh_reference.run_reference``): ``backbone.forward`` of xlstm, zamba2,
internvl2 and whisper smoke at f32 on one device and under
``axis_rules(make_rules(mode))`` and ``jax.set_mesh`` of a ``("data",
"model")`` mesh, on the same numpy inputs (``model_run.case_inputs``: the
tokens, the vlm's patches ahead of them, whisper's frames).  Its parameters
cross into the port by name, and ``repro_torch.dist.model_run`` runs every
case's prefill step and the forward of every position in ONE spawn of 8
``gloo`` CPU ranks.  Every position's logits agree with both of the
reference's at atol 1e-4.  Cases: each family under ``tp``, ``tp_sp``,
``fsdp`` and ``tp2d`` on ``(2, 4)``, and xlstm and whisper under ``tp`` on
``(4, 2)``, where the mLSTM's 2 heads and the cross-attention's 6 (which do
not divide over 4) really shard.  What runs per rank: the mLSTM on its
heads, the sLSTM whole on its rows from the gathered gates, the Mamba2 on a
block of whole heads from the gathered fused ``in_xz`` product, attention
and cross-attention on the rank's query heads.
"""
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

from repro_torch.dist import model_run

import mesh_reference as mr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
BATCH, SEQ = 4, 32
FAMILIES = ("xlstm-125m", "zamba2-1.2b", "internvl2-1b", "whisper-small")
_BASE = dict(batch=BATCH, seq=SEQ, smoke=True, param_dtype="float32", all_positions=True)
CASES = [(f"{arch.split('-')[0]}_{mode}", model_run.Case(arch, mode=mode, **_BASE))
         for arch in FAMILIES for mode in ("tp", "tp_sp", "fsdp", "tp2d")] + [
    (f"{arch.split('-')[0]}_tp_4x2", model_run.Case(arch, mode="tp", mesh=(4, 2), **_BASE))
    for arch in ("xlstm-125m", "whisper-small")]
NAMES = [name for name, _ in CASES]


def _reference(d):
    """The reference's one-device and mesh forward of every case: its
    parameters and logits land in d."""
    spec = []
    for name, case in CASES:
        spec.append({"name": name, "arch": mr.ARCHS[case.arch], "mode": case.mode,
                     "mesh": list(case.mesh), "inputs": os.path.join(d, f"{name}_in.npz")})
        np.savez(spec[-1]["inputs"], **model_run.case_inputs(case))
    mr.run_reference(f"""
        from repro.models import backbone
        d = {d!r}
        singles = {{}}
        for case in json.loads({json.dumps(json.dumps(spec))}):
            cfg = case_config(case)
            params, _ = backbone.init_model(jax.random.key(0), cfg)
            np.savez(f"{{d}}/{{case['name']}}_params.npz", **flat(params))
            batch = dict(np.load(case["inputs"]))
            fwd = jax.jit(lambda p, b: backbone.forward(p, cfg, b)[0])
            if case["arch"] not in singles:
                singles[case["arch"]] = np.asarray(fwd(params, batch), np.float32)
            with axis_rules(make_rules(case["mode"])), jax.set_mesh(make_mesh(case["mesh"])):
                logits = jax.jit(lambda p, b: backbone.forward(p, cfg, b)[0])(params, batch)
            np.savez(f"{{d}}/{{case['name']}}_out.npz", single=singles[case["arch"]],
                     mesh=np.asarray(logits, np.float32))
        print("OK")
    """)


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as d:
        _reference(d)
        cases = []
        for name, case in CASES:
            with np.load(os.path.join(d, f"{name}_params.npz")) as f:
                arrays = mr.port_arrays(model_run.case_config(case), dict(f))
            path = os.path.join(d, f"{name}_port.npz")
            np.savez(path, **arrays)
            cases.append(dataclasses.replace(case, params=path, use_flash=True))
        rows = model_run.run(cases, workdir=os.path.join(d, "run"), device="cpu")
        out = {}
        for (name, case), row in zip(CASES, rows):
            with np.load(os.path.join(d, f"{name}_out.npz")) as f:
                out[name] = (case, row, dict(f))
        yield out


@pytest.mark.parametrize("name", NAMES)
def test_mesh_forward_matches_reference_mesh_forward(runs, name):
    case, row, ref = runs[name]
    cfg = model_run.case_config(case)
    assert row["logits_all"].shape == (BATCH, SEQ, cfg.padded_vocab)
    np.testing.assert_allclose(row["logits_all"], ref["mesh"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(row["logits"], ref["mesh"][:, -1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_forward_matches_one_device_forward(runs, name):
    _, row, ref = runs[name]
    np.testing.assert_allclose(row["logits_all"], ref["single"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_forward_runs_each_rank_on_its_heads(runs, name):
    """The attention (the flash kernel's plain version on the CPU, no
    launch) takes each rank's query heads, whole sequences: 4 model ranks
    split internvl2's 7 heads and whisper's 6 not, 2 split whisper's 6;
    every family but xlstm attends."""
    case, row, _ = runs[name]
    cfg = model_run.case_config(case)
    model = case.mesh[1]
    for rank in row["ranks"]:
        assert rank["flash_launches"] == 0
        assert rank["collectives"].get("all_reduce", 0) > 0  # partial sums reduced
        if cfg.family == "ssm":
            assert rank["flash_max_abs_err"] is None  # no attention
            continue
        assert rank["flash_max_abs_err"] == 0.0
        heads = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads
        seq = cfg.encoder_seq if cfg.family == "audio" else SEQ  # the encoder attends first
        assert rank["flash_shape"]["q"] == [BATCH // case.mesh[0], seq, heads, cfg.head_dim]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_prefill_runs_no_collective_of_its_own(runs, name):
    """Every collective of these prefills is a DTensor redistribution: the
    per-rank cores gather their inputs through ``local_map``'s layouts, and
    none calls ``mesh_collectives`` (the Mamba2 decode's gather does:
    ``test_torch_mesh_families_train``)."""
    _, row, _ = runs[name]
    for rank in row["ranks"]:
        assert sum(rank["moe_collectives"].values()) == 0
        assert rank["backward_collectives"] == {}
