"""Port parity: prefill, training and decode over a (pod 2, data 2, model 2)
mesh.

The reference runs in a subprocess with 8 XLA CPU devices on a ``(2, 2, 2)``
``("pod", "data", "model")`` mesh under ``make_rules(mode, multi_pod=True)``
(the batch sharded over ``("pod", "data")``), as its dry run lays out the
multi-pod production mesh: ``backbone.forward`` for the prefill, the jitted
``make_train_step`` with the dry run's shardings for training, the jitted
``make_decode_step`` fed the prompts one token a step then 4 greedy tokens
for decode.  Its parameters cross into the port by name, and
``repro_torch.dist.model_run`` runs every case with ``Case(mesh=(2, 2, 2))``
in ONE spawn of 8 ``gloo`` CPU ranks at f32.  Tolerances are those of
``test_torch_mesh_{model,train,decode}.py``: the prefill's logits atol 1e-4;
the train step's loss and norm rtol 1e-5, parameters atol 2e-5, moments
1e-7 and 1e-8; decode's logits atol 1e-4 with the greedy tokens equal.
Cases: StarCoder2-3B smoke and dbrx smoke (expert parallel, capacity 8.0)
prefill under ``tp`` and train under ``fsdp``; StarCoder2-3B smoke decode
under ``tp``.  The collectives' bytes are told apart by mesh axis: the batch
over the pod axis makes the pod group run the train step's gradient
reductions.
"""
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

from repro_torch.dist import model_run
from repro_torch.dist.sharding import make_rules

import mesh_reference as mr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESH = (2, 2, 2)
ATOL = 1e-4
RTOL, PARAM_ATOL, M_ATOL, V_ATOL = 1e-5, 2e-5, 1e-7, 1e-8
BATCH, SEQ = 4, 32
PROMPT, NEW, KV_LEN = 8, 4, 16
_COMMON = dict(mesh=MESH, batch=BATCH, smoke=True, param_dtype="float32")
_TRAIN = dict(kind="train", mode="fsdp", seq=SEQ, save_state=True, xent_tile=64, **_COMMON)
CASES = [
    ("starcoder_prefill", model_run.Case("starcoder2-3b", mode="tp", seq=SEQ,
                                         all_positions=True, use_flash=True, **_COMMON)),
    ("dbrx_prefill", model_run.Case("dbrx-132b", mode="tp", seq=SEQ, capacity_factor=8.0,
                                    all_positions=True, **_COMMON)),
    ("starcoder_train", model_run.Case("starcoder2-3b", remat="full", **_TRAIN)),
    ("dbrx_train", model_run.Case("dbrx-132b", capacity_factor=8.0, **_TRAIN)),
    ("starcoder_decode", model_run.Case("starcoder2-3b", kind="decode", mode="tp", seq=PROMPT,
                                        new=NEW, kv_len=KV_LEN, all_positions=True,
                                        **_COMMON)),
]
NAMES = [name for name, _ in CASES]


def _reference(d):
    spec = []
    for name, case in CASES:
        tcfg = model_run.train_config(case)
        spec.append({"name": name, "kind": case.kind, "arch": mr.ARCHS[case.arch],
                     "mode": case.mode, "cf": case.capacity_factor, "sharding": None,
                     "remat": case.remat, "lr": tcfg.schedule.peak_lr,
                     "warmup": tcfg.schedule.warmup_steps, "step": model_run.TRAIN_WARMUP,
                     "state_dtype": tcfg.optimizer.state_dtype, "tile": tcfg.xent_tile,
                     "inputs": os.path.join(d, f"{name}_inputs.npz")})
        inputs = model_run.case_batch(case) if case.kind == "train" else model_run.case_inputs(case)
        np.savez(spec[-1]["inputs"], **inputs)
    mr.run_reference(f"""
        from repro.launch.dryrun import _batch_axes, _named, _specs
        from repro.models import backbone
        from repro.models.common import spec as axspec
        from repro.serve.serve_step import make_decode_step
        from repro.train import TrainConfig, make_train_step
        from repro.train.optimizer import AdamWConfig, init_opt_state, opt_state_axes
        from repro.train.schedule import ScheduleConfig
        d = {d!r}
        mesh = make_mesh({MESH!r})
        for case in json.loads({json.dumps(json.dumps(spec))}):
            cfg = case_config(case)
            params, paxes = backbone.init_model(jax.random.key(0), cfg)
            np.savez(f"{{d}}/{{case['name']}}_params.npz", **flat(params))
            inputs = dict(np.load(case["inputs"]))
            rules = make_rules(case["mode"], multi_pod=True)
            out = {{}}
            tcfg = TrainConfig(
                optimizer=AdamWConfig(state_dtype=case["state_dtype"]),
                schedule=ScheduleConfig(kind="wsd", peak_lr=case["lr"],
                                        warmup_steps=case["warmup"]),
                attn_chunk=512, xent_tile=case["tile"])
            opt = init_opt_state(params, tcfg.optimizer)
            if case["kind"] == "decode":
                prompts = inputs["tokens"]
                b = prompts.shape[0]
                state, saxes = backbone.init_decode_state(cfg, b, {KV_LEN})
                tok0 = jnp.zeros((b, 1), jnp.int32)
            with axis_rules(rules), jax.set_mesh(mesh):
                if case["kind"] == "prefill":
                    logits, aux = jax.jit(lambda p, b: backbone.forward(p, cfg, b))(params, inputs)
                    out["logits"] = np.asarray(logits, np.float32)
                elif case["kind"] == "train":
                    p_sh = _named(mesh, paxes, params)
                    o_sh = _named(mesh, opt_state_axes(paxes), opt)
                    b_sh = _named(mesh, _batch_axes(inputs), inputs)
                    step = make_train_step(cfg, tcfg, param_specs=_specs(mesh, paxes, params))
                    new_p, new_o, metrics = jax.jit(
                        step, in_shardings=(p_sh, o_sh, b_sh, None),
                        out_shardings=(p_sh, o_sh, None))(params, opt, inputs,
                                                          jnp.int32(case["step"]))
                    out.update({{**flat(new_p, "params."), **flat(new_o["m"], "m."),
                                **flat(new_o["v"], "v."),
                                **{{f"metric.{{k}}": np.asarray(v) for k, v in metrics.items()}}}})
                else:
                    p_sh = _named(mesh, paxes, params)
                    s_sh = _named(mesh, saxes, state)
                    tok_sh = _named(mesh, {{"tokens": axspec("batch", None)}}, {{"tokens": tok0}})
                    step = jax.jit(make_decode_step(cfg),
                                   in_shardings=(p_sh, s_sh, tok_sh["tokens"], None),
                                   out_shardings=(None, s_sh))
                    every, toks = [], []
                    for t in range(prompts.shape[1]):
                        logits, state = step(params, state, jnp.asarray(prompts[:, t:t + 1]),
                                             jnp.int32(t))
                        every.append(np.asarray(logits, np.float32))
                    tok = np.zeros((b,), np.int32)
                    for n in range({NEW}):
                        logits, state = step(params, state, jnp.asarray(tok[:, None]),
                                             jnp.int32(prompts.shape[1] + n))
                        every.append(np.asarray(logits, np.float32))
                        tok = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
                        toks.append(tok)
                    out.update(logits=np.stack(every), tokens=np.stack(toks, axis=1))
            np.savez(f"{{d}}/{{case['name']}}_out.npz", **out)
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
        out = {}
        for (name, case), row in zip(CASES, rows):
            with np.load(os.path.join(d, f"{name}_out.npz")) as f:
                out[name] = (case, row, dict(f))
        yield out


def test_multi_pod_rules_shard_the_batch_over_pod_and_data():
    """The case's rules are the reference's multi-pod table."""
    case = dict(CASES)["starcoder_train"]
    assert model_run.mesh_axes(case) == ("pod", "data", "model")
    rules = model_run.case_rules(case)
    assert rules.multi_pod and rules.mesh_axes("batch") == ("pod", "data")
    assert rules.mesh_axes("embed") == make_rules("fsdp").mesh_axes("embed")


@pytest.mark.parametrize("name", ["starcoder_prefill", "dbrx_prefill"])
def test_pod_prefill_matches_reference(runs, name):
    case, row, ref = runs[name]
    np.testing.assert_allclose(row["logits_all"], ref["logits"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(row["logits"], ref["logits"][:, -1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["starcoder_train", "dbrx_train"])
def test_pod_train_step_matches_reference(runs, name):
    case, row, ref = runs[name]
    for rank in row["ranks"]:
        np.testing.assert_allclose(rank["loss"], ref["metric.loss"], rtol=RTOL)
        np.testing.assert_allclose(rank["grad_norm"], ref["metric.grad_norm"], rtol=RTOL)
    cfg = model_run.case_config(case)
    for key, atol in (("params", PARAM_ATOL), ("m", M_ATOL), ("v", V_ATOL)):
        want = mr.port_arrays(cfg, {k[len(key) + 1:]: v for k, v in ref.items()
                                    if k.startswith(key + ".")})
        for pname, w in want.items():
            np.testing.assert_allclose(row["state"][f"{key}.{pname}"], w, atol=atol, rtol=0,
                                       err_msg=f"{key}.{pname}")


def test_pod_decode_matches_reference(runs):
    case, row, ref = runs["starcoder_decode"]
    np.testing.assert_allclose(row["logits_all"], ref["logits"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(row["tokens"], ref["tokens"])
    for rank in row["ranks"]:
        np.testing.assert_array_equal(np.array(rank["tokens"]), ref["tokens"])


@pytest.mark.parametrize("name", ["starcoder_train", "dbrx_train"])
def test_pod_axis_carries_the_gradient_reductions(runs, name):
    """Every rank's collectives name the axis whose group ran them: the
    batch split over pod x data makes both reduce a train step's
    gradients, so each moves bytes; under fsdp the weights' gathers run
    over ``data`` alone."""
    case, row, _ = runs[name]
    for rank in row["ranks"]:
        by_axis = rank["collective_bytes_by_axis"]
        assert by_axis.get("pod", 0) > 0 and by_axis.get("data", 0) > 0, by_axis
        assert "other" not in by_axis, by_axis
