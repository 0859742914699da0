"""Port parity: training over a (data 2, model 4) mesh.

The reference runs in a subprocess with 8 XLA CPU devices: its
``make_train_step(cfg, tcfg, param_specs=...)`` jitted with the parameter,
optimizer and batch shardings that ``launch/dryrun.py::run_cell`` builds,
under ``axis_rules(make_rules(mode))`` and ``jax.set_mesh``.  Its parameters
cross into the port by name (``models.weights.named_arrays``), and
``repro_torch.dist.model_run`` runs every case's ``make_train_step(cfg, tcfg,
mesh=, rules=)`` in ONE spawn of 8 ``gloo`` CPU ranks at f32, on the same
numpy batch.  Held at ``tests/test_torch_train.py``'s tolerances: the loss,
``grad_norm`` and the MoE's ``aux`` rtol 1e-5, the updated parameters atol
2e-5, the first moments atol 1e-7 and the second atol 1e-8.  Cases:

* StarCoder2-3B smoke under ``fsdp`` (every block rematerialised, so the
  checkpoints recompute the mesh's collectives in the backward) and
  ``tp_sp``;
* dbrx smoke (expert parallel: two ``all_to_all`` a layer each way) under
  ``tp`` and ``fsdp``;
* grok smoke with ``sharding="ffn"`` under ``tp_sp`` (tokens gathered over
  ``model``, the outputs reduce-scattered back);
* StarCoder2-3B smoke under ``tp2d`` in 2 microbatches, so that each
  microbatch's gradients are pinned to their parameters' placements
  (``_pin_to_specs``; ``_StridedShard`` layouts among them).

The MoEs run at capacity 8.0; each rank counts capacity over its own tokens
in both packages, and each package's ``aux`` is the mean of the ranks' own.
The cross-entropy's tiles are 64 lm-head rows, which divide each rank's vocab
shard (512 / 4): where they do not, the reference pads the shard to whole
tiles and counts the padded rows as vocab entries (their global index lies
below the vocab, in the next shards' range), so its mesh loss departs from
its own one-device loss (7.178 against 6.273 for StarCoder2-3B smoke at the
default tile of 2048); the port tiles the shard as it is.
In every rank a backward through an op without an autograd kernel raises
(``model_run.autograd_fallback_is_an_error``).  The mesh form of
``vocab_parallel_xent`` is also held, in value and both gradients, to the
reference's on ``tests/test_dist.py``'s inputs (rtol 1e-5, atol 1e-5), in a
second spawn; and ``opt_state_axes`` to the reference's by name.
"""
import dataclasses
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import backbone as rbb
from repro.train.optimizer import opt_state_axes as ref_opt_state_axes

from repro_torch import configs as tconfigs
from repro_torch.dist import model_run
from repro_torch.dist.spawn import spawn_ranks
from repro_torch.models import backbone as tbb
from repro_torch.models.weights import param_axes
from repro_torch.train.optimizer import opt_state_axes

import mesh_reference as mr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BATCH, SEQ = 4, 32
RTOL, PARAM_ATOL, M_ATOL, V_ATOL = 1e-5, 2e-5, 1e-7, 1e-8
# lm-head tiles of 64 rows: two to each rank's vocab shard of 128 (see below)
_BASE = dict(kind="train", batch=BATCH, seq=SEQ, smoke=True, param_dtype="float32",
             save_state=True, xent_tile=64)
CASES = [
    ("starcoder_fsdp", model_run.Case("starcoder2-3b", mode="fsdp", remat="full", **_BASE)),
    ("starcoder_tp_sp", model_run.Case("starcoder2-3b", mode="tp_sp", **_BASE)),
    ("dbrx_tp", model_run.Case("dbrx-132b", mode="tp", capacity_factor=8.0, **_BASE)),
    ("dbrx_fsdp", model_run.Case("dbrx-132b", mode="fsdp", capacity_factor=8.0, **_BASE)),
    ("grok_tp_sp", model_run.Case("grok-1-314b", mode="tp_sp", moe_sharding="ffn",
                                  capacity_factor=8.0, **_BASE)),
    ("starcoder_tp2d_micro2", model_run.Case("starcoder2-3b", mode="tp2d", microbatches=2,
                                             **_BASE)),
]
NAMES = [name for name, _ in CASES]


def _reference(d):
    """The reference's one train step of every case, and its vocab-parallel
    cross-entropy on tests/test_dist.py's inputs: arrays land in d."""
    spec = []
    for name, case in CASES:
        tcfg = model_run.train_config(case)
        spec.append({"name": name, "arch": mr.ARCHS[case.arch], "mode": case.mode,
                     "cf": case.capacity_factor, "sharding": case.moe_sharding,
                     "remat": case.remat, "micro": case.microbatches,
                     "lr": tcfg.schedule.peak_lr, "warmup": tcfg.schedule.warmup_steps,
                     "step": model_run.TRAIN_WARMUP, "state_dtype": tcfg.optimizer.state_dtype,
                     "tile": tcfg.xent_tile,
                     "batch": os.path.join(d, f"{name}_batch.npz")})
        np.savez(spec[-1]["batch"], **model_run.case_batch(case))
    mr.run_reference(f"""
        from repro.launch.dryrun import _batch_axes, _named, _specs
        from repro.models import backbone
        from repro.train import TrainConfig, make_train_step
        from repro.train.optimizer import AdamWConfig, init_opt_state, opt_state_axes
        from repro.train.schedule import ScheduleConfig
        from repro.train.xent import vocab_parallel_xent
        d = {d!r}
        mesh = make_mesh()
        for case in json.loads({json.dumps(json.dumps(spec))}):
            cfg = case_config(case)
            tcfg = TrainConfig(
                optimizer=AdamWConfig(state_dtype=case["state_dtype"]),
                schedule=ScheduleConfig(kind="wsd", peak_lr=case["lr"],
                                        warmup_steps=case["warmup"]),
                microbatches=case["micro"], attn_chunk=512, xent_tile=case["tile"])
            params, paxes = backbone.init_model(jax.random.key(0), cfg)
            np.savez(f"{{d}}/{{case['name']}}_params.npz", **flat(params))
            opt = init_opt_state(params, tcfg.optimizer)
            batch = dict(np.load(case["batch"]))
            with axis_rules(make_rules(case["mode"])), jax.set_mesh(mesh):
                p_sh = _named(mesh, paxes, params)
                o_sh = _named(mesh, opt_state_axes(paxes), opt)
                b_sh = _named(mesh, _batch_axes(batch), batch)
                step = make_train_step(cfg, tcfg, param_specs=_specs(mesh, paxes, params))
                new_p, new_o, metrics = jax.jit(
                    step, in_shardings=(p_sh, o_sh, b_sh, None),
                    out_shardings=(p_sh, o_sh, None))(params, opt, batch, jnp.int32(case["step"]))
            out = {{**flat(new_p, "params."), **flat(new_o["m"], "m."), **flat(new_o["v"], "v."),
                   **{{f"metric.{{k}}": np.asarray(v) for k, v in metrics.items()}}}}
            np.savez(f"{{d}}/{{case['name']}}_out.npz", **out)
        # tests/test_dist.py::test_vocab_parallel_xent_matches_plain's inputs
        b, s, dm, vp, real = 4, 8, 16, 64, 60
        x = jax.random.normal(jax.random.key(0), (b, s, dm), jnp.float32)
        w = jax.random.normal(jax.random.key(1), (vp, dm), jnp.float32) * 0.3
        labels = jax.random.randint(jax.random.key(2), (b, s), 0, real)
        labels = labels.at[0, 0].set(-1)
        with jax.set_mesh(mesh):
            fn = jax.jit(jax.value_and_grad(lambda x_, w_: vocab_parallel_xent(
                x_, w_, labels, real, mesh=mesh, tile=8), argnums=(0, 1)))
            loss, (gx, gw) = fn(x, w)
        np.savez(f"{{d}}/xent.npz", x=np.asarray(x), w=np.asarray(w),
                 labels=np.asarray(labels, np.int64), real=np.int64(real), loss=np.asarray(loss),
                 gx=np.asarray(gx), gw=np.asarray(gw))
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
            cases.append(dataclasses.replace(case, params=path))
        rows = model_run.run(cases, workdir=os.path.join(d, "run"), device="cpu")
        xent = spawn_ranks(mr.xent_rank, 8, os.path.join(d, "xent"),
                           (os.path.join(d, "xent.npz"),), device="cpu")
        out = {}
        for (name, case), row in zip(CASES, rows):
            with np.load(os.path.join(d, f"{name}_out.npz")) as f:
                ref = dict(f)
            cfg = model_run.case_config(case)
            out[name] = (case, row, {key: mr.port_arrays(cfg, {
                k[len(key) + 1:]: v for k, v in ref.items() if k.startswith(key + ".")})
                for key in ("params", "m", "v")}, ref)
        with np.load(os.path.join(d, "xent.npz")) as f:
            out["xent"] = (xent, dict(f))
        yield out


@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_loss_and_norm_match_reference(runs, name):
    case, row, _, ref = runs[name]
    for rank in row["ranks"]:  # a plain value, the same on every rank
        np.testing.assert_allclose(rank["loss"], ref["metric.loss"], rtol=RTOL)
        np.testing.assert_allclose(rank["grad_norm"], ref["metric.grad_norm"], rtol=RTOL)
        np.testing.assert_allclose(rank["moe_aux"], ref["metric.moe_aux"], rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(rank["lr"], ref["metric.lr"], rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_state_matches_reference(runs, name):
    case, row, want, _ = runs[name]
    got = row["state"]
    assert {k.split(".", 1)[1] for k in got if k.startswith("params.")} == want["params"].keys()
    for key, atol in (("params", PARAM_ATOL), ("m", M_ATOL), ("v", V_ATOL)):
        for pname, w in want[key].items():
            np.testing.assert_allclose(got[f"{key}.{pname}"], w, atol=atol, rtol=0,
                                       err_msg=f"{key}.{pname}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_collectives(runs, name):
    """The MoE's own collectives run in both directions: the dispatch and the
    return (EP), or the token gather and the output scatter (grok under
    tp_sp), once a layer forward and once more, reversed, backward; every
    backward reduces the cross-entropy's dx over ``model``."""
    case, row, _, _ = runs[name]
    cfg = model_run.case_config(case)
    per_layer = cfg.n_layers * case.microbatches
    for rank in row["ranks"]:
        fwd, bwd = rank["moe_collectives_by_phase"]["forward"], \
            rank["moe_collectives_by_phase"]["backward"]
        assert rank["backward_collectives"], "no collective ran in the backward"
        assert bwd["all_reduce"] >= case.microbatches  # the cross-entropy's dx
        if cfg.moe is None:
            assert fwd["all_to_all"] == bwd["all_to_all"] == 0
        elif case.moe_sharding == "ffn":
            assert fwd["all_gather"] == fwd["reduce_scatter"] == per_layer
            assert bwd["all_gather"] == bwd["reduce_scatter"] == per_layer
        else:
            assert fwd["all_to_all"] == bwd["all_to_all"] == 2 * per_layer
        if cfg.moe is not None:
            assert rank["pairs_routed"] > 0 and rank["pairs_dropped"] == 0


def test_mesh_train_step_updates_every_parameter(runs):
    """Each rank's step moved every parameter (lr at its peak), the
    gathered parameters are finite, and the moments laid out as the
    parameters came back whole."""
    case, row, want, _ = runs["starcoder_fsdp"]
    with np.load(row["case"]["params"]) as f:
        before = dict(f)
    for pname in want["params"]:
        got = row["state"][f"params.{pname}"]
        assert np.isfinite(got).all()
        assert not np.array_equal(got, before[pname]), pname


def test_vocab_parallel_xent_over_a_mesh_matches_reference(runs):
    ranks, ref = runs["xent"]
    for rank in ranks:
        got = rank[0]
        np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(np.array(got["gx"]), ref["gx"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(np.array(got["gw"]), ref["gw"], atol=1e-5, rtol=1e-5)
        assert got["gw_on_vocab_shard"]  # the weight's gradient stays on its vocab shard


def test_autograd_fallback_is_an_error():
    """What the train ranks run under: a backward through an op that has no
    autograd kernel raises instead of going on with a wrong gradient."""
    lib = torch.library.Library("mesh_train_probe", "DEF")
    try:
        lib.define("twice(Tensor x) -> Tensor")
        lib.impl("twice", lambda x: x * 2, "CPU")
        x = torch.ones(3, requires_grad=True)
        y = torch.ops.mesh_train_probe.twice(x)
        with model_run.autograd_fallback_is_an_error(), \
                pytest.raises(UserWarning, match="autograd kernel was not registered"):
            torch.autograd.grad(y.sum(), [x])
    finally:
        lib._destroy()


def _flat_axes(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for key, sub in tree.items():
            out.update(_flat_axes(sub, f"{prefix}{key}."))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            out.update(_flat_axes(sub, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tuple(tree)
    return out


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_opt_state_axes_equal_reference(arch):
    """The moments' axes are the parameters' under the port's names (a
    stacked layer of the reference loses its leading None), the count's
    none."""
    params, axes = rbb.init_model(jax.random.key(0), rconfigs.get_smoke(arch))
    ref = ref_opt_state_axes(axes)
    model = tbb.Backbone(tconfigs.get_smoke(arch), device="meta")
    got = opt_state_axes(param_axes(model))
    assert tuple(got["count"]) == tuple(ref["count"]) == ()
    for key in ("m", "v"):
        want = {}
        for name, ax in _flat_axes(ref[key]).items():
            stack, _, rest = name.partition(".")
            if stack in ("blocks", "mamba_main", "mamba_rem", "encoder") \
                    and isinstance(ref[key][stack], dict):
                assert ax[0] is None
                for i in range(jax.tree.leaves(params[stack])[0].shape[0]):
                    want[f"{stack}.{i}.{rest}"] = ax[1:]
            else:
                want[name] = ax
        assert {name: tuple(ax) for name, ax in got[key].items()} == want
