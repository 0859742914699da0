"""Port parity: the ssm, hybrid, vlm and audio families trained and decoded
over a (data 2, model 4) mesh.

The reference runs in a subprocess with 8 XLA CPU devices: its
``make_train_step(cfg, tcfg, param_specs=...)`` jitted with the parameter,
optimizer and batch shardings that ``launch/dryrun.py::run_cell`` builds,
and its ``make_decode_step(cfg)`` jitted with the parameter, decode-state and
token shardings, fed the prompts one token a step and then 4 greedy tokens
from token 0, as the serving engine feeds them (whisper's state holds its
encoder's output over the frames).  Its parameters cross into the port by
name, and ``repro_torch.dist.model_run`` runs every case in ONE spawn of 8
``gloo`` CPU ranks at f32, on the same numpy inputs (``model_run.case_batch``
and ``case_inputs``: the vlm's patches, whose labels are -1, and whisper's
frames).  Train cases: one step of each family under ``fsdp``, zamba2 under
``tp_sp`` and whisper under ``tp2d``, held at ``test_torch_mesh_train``'s
tolerances (loss and norm rtol 1e-5, parameters atol 2e-5, moments 1e-7 and
1e-8).  Decode cases: each family under ``tp``, every step's logits at atol
1e-4 and the greedy tokens equal.
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

RTOL, PARAM_ATOL, M_ATOL, V_ATOL = 1e-5, 2e-5, 1e-7, 1e-8
ATOL = 1e-4
BATCH, SEQ = 4, 32
PROMPT, NEW, KV_LEN = 8, 4, 16
_TRAIN = dict(kind="train", batch=BATCH, seq=SEQ, smoke=True, param_dtype="float32",
              save_state=True, xent_tile=64)
_DECODE = dict(kind="decode", batch=BATCH, seq=PROMPT, new=NEW, kv_len=KV_LEN, smoke=True,
               param_dtype="float32", all_positions=True)
FAMILIES = ("xlstm-125m", "zamba2-1.2b", "internvl2-1b", "whisper-small")
TRAIN = [(f"{arch.split('-')[0]}_fsdp", model_run.Case(arch, mode="fsdp", **_TRAIN))
         for arch in FAMILIES] + [
    ("zamba2_tp_sp", model_run.Case("zamba2-1.2b", mode="tp_sp", **_TRAIN)),
    ("whisper_tp2d", model_run.Case("whisper-small", mode="tp2d", **_TRAIN))]
DECODE = [(f"{arch.split('-')[0]}_decode_tp", model_run.Case(arch, mode="tp", **_DECODE))
          for arch in FAMILIES]
CASES = TRAIN + DECODE


def _reference(d):
    spec = []
    for name, case in CASES:
        tcfg = model_run.train_config(case)
        inputs = model_run.case_batch(case) if case.kind == "train" else model_run.case_inputs(case)
        spec.append({"name": name, "kind": case.kind, "arch": mr.ARCHS[case.arch],
                     "mode": case.mode, "lr": tcfg.schedule.peak_lr,
                     "warmup": tcfg.schedule.warmup_steps, "step": model_run.TRAIN_WARMUP,
                     "state_dtype": tcfg.optimizer.state_dtype, "tile": tcfg.xent_tile,
                     "inputs": os.path.join(d, f"{name}_in.npz")})
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
        mesh = make_mesh()
        for case in json.loads({json.dumps(json.dumps(spec))}):
            cfg = case_config(case)
            params, paxes = backbone.init_model(jax.random.key(0), cfg)
            np.savez(f"{{d}}/{{case['name']}}_params.npz", **flat(params))
            inputs = dict(np.load(case["inputs"]))
            if case["kind"] == "train":
                tcfg = TrainConfig(
                    optimizer=AdamWConfig(state_dtype=case["state_dtype"]),
                    schedule=ScheduleConfig(kind="wsd", peak_lr=case["lr"],
                                            warmup_steps=case["warmup"]),
                    attn_chunk=512, xent_tile=case["tile"])
                opt = init_opt_state(params, tcfg.optimizer)
                with axis_rules(make_rules(case["mode"])), jax.set_mesh(mesh):
                    p_sh = _named(mesh, paxes, params)
                    o_sh = _named(mesh, opt_state_axes(paxes), opt)
                    b_sh = _named(mesh, _batch_axes(inputs), inputs)
                    step = make_train_step(cfg, tcfg, param_specs=_specs(mesh, paxes, params))
                    new_p, new_o, metrics = jax.jit(
                        step, in_shardings=(p_sh, o_sh, b_sh, None),
                        out_shardings=(p_sh, o_sh, None))(params, opt, inputs,
                                                          jnp.int32(case["step"]))
                out = {{**flat(new_p, "params."), **flat(new_o["m"], "m."),
                       **flat(new_o["v"], "v."),
                       **{{f"metric.{{k}}": np.asarray(v) for k, v in metrics.items()}}}}
                np.savez(f"{{d}}/{{case['name']}}_out.npz", **out)
                continue
            prompts = inputs["tokens"]
            b = prompts.shape[0]
            state, saxes = backbone.init_decode_state(cfg, b, {KV_LEN})
            if "frames" in inputs:
                state["enc"] = backbone._run_encoder(params, cfg, jnp.asarray(inputs["frames"]))
            tok0 = jnp.zeros((b, 1), jnp.int32)
            with axis_rules(make_rules(case["mode"])), jax.set_mesh(mesh):
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
                tok = np.zeros((b,), np.int32)  # the engine's generate starts from token 0
                for n in range({NEW}):
                    logits, state = step(params, state, jnp.asarray(tok[:, None]),
                                         jnp.int32(prompts.shape[1] + n))
                    every.append(np.asarray(logits, np.float32))
                    tok = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
                    toks.append(tok)
            np.savez(f"{{d}}/{{case['name']}}_out.npz", logits=np.stack(every),
                     tokens=np.stack(toks, axis=1))
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
                ref = dict(f)
            if case.kind == "train":
                cfg = model_run.case_config(case)
                out[name] = (case, row, {key: mr.port_arrays(cfg, {
                    k[len(key) + 1:]: v for k, v in ref.items() if k.startswith(key + ".")})
                    for key in ("params", "m", "v")}, ref)
            else:
                out[name] = (case, row, ref)
        yield out


TRAIN_NAMES = [name for name, _ in TRAIN]
DECODE_NAMES = [name for name, _ in DECODE]


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_mesh_train_step_loss_and_norm_match_reference(runs, name):
    _, row, _, ref = runs[name]
    for rank in row["ranks"]:  # a plain value, the same on every rank
        np.testing.assert_allclose(rank["loss"], ref["metric.loss"], rtol=RTOL)
        np.testing.assert_allclose(rank["grad_norm"], ref["metric.grad_norm"], rtol=RTOL)
        np.testing.assert_allclose(rank["lr"], ref["metric.lr"], rtol=1e-6)


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_mesh_train_step_state_matches_reference(runs, name):
    _, row, want, _ = runs[name]
    got = row["state"]
    assert {k.split(".", 1)[1] for k in got if k.startswith("params.")} == want["params"].keys()
    for key, atol in (("params", PARAM_ATOL), ("m", M_ATOL), ("v", V_ATOL)):
        for pname, w in want[key].items():
            np.testing.assert_allclose(got[f"{key}.{pname}"], w, atol=atol, rtol=0,
                                       err_msg=f"{key}.{pname}")


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_mesh_train_step_moves_every_parameter(runs, name):
    """lr at its peak: every parameter moved, and each is finite; every
    rank's backward ran collectives (the gathered weights' transposes)."""
    _, row, want, _ = runs[name]
    with np.load(row["case"]["params"]) as f:
        before = dict(f)
    for pname in want["params"]:
        got = row["state"][f"params.{pname}"]
        assert np.isfinite(got).all()
        assert not np.array_equal(got, before[pname]), pname
    for rank in row["ranks"]:
        assert rank["backward_collectives"], "no collective ran in the backward"


@pytest.mark.parametrize("name", DECODE_NAMES)
def test_mesh_decode_logits_match_reference(runs, name):
    case, row, ref = runs[name]
    assert row["logits_all"].shape == ref["logits"].shape == (
        PROMPT + NEW, BATCH, model_run.case_config(case).padded_vocab)
    np.testing.assert_allclose(row["logits_all"], ref["logits"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(row["logits"], ref["logits"][PROMPT - 1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", DECODE_NAMES)
def test_mesh_decode_greedy_tokens_match_reference(runs, name):
    _, row, ref = runs[name]
    np.testing.assert_array_equal(row["tokens"], ref["tokens"])
    for rank in row["ranks"]:  # every rank sampled the same tokens
        np.testing.assert_array_equal(np.array(rank["tokens"]), ref["tokens"])


@pytest.mark.parametrize("name", DECODE_NAMES)
def test_mesh_decode_collectives(runs, name):
    """Nothing in decode runs a backward; the Mamba2 step gathers its conv
    outputs over ``model`` once a layer a token (``mesh_collectives``), and
    no other family calls them."""
    case, row, _ = runs[name]
    cfg = model_run.case_config(case)
    for rank in row["ranks"]:
        assert rank["backward_collectives"] == {}
        gathers = rank["moe_collectives"]["all_gather"]
        assert gathers == (cfg.n_layers * NEW if cfg.family == "hybrid" else 0)
        assert sum(rank["moe_collectives"].values()) == gathers
