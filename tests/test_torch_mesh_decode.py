"""Port parity: decode over a (data 2, model 4) mesh.

The reference runs in a subprocess with 8 XLA CPU devices: its
``make_decode_step(cfg)`` jitted with the parameter, decode-state and token
shardings that ``launch/dryrun.py::run_cell`` builds (the state's from
``init_decode_state``'s axes), under ``axis_rules(make_rules(mode))`` and
``jax.set_mesh``, fed the prompts one token a step and then 4 greedy tokens
from token 0, as the serving engine feeds them.  Its parameters cross into
the port by name, and ``repro_torch.dist.model_run`` runs every case's
``ServeEngine`` over the mesh in ONE spawn of 8 ``gloo`` CPU ranks at f32:
every step's logits agree at atol 1e-4 and the greedy tokens are equal.
Cases: StarCoder2-3B smoke under ``tp`` and ``tp_sp`` (its 2 kv heads
replicated over ``model``), dbrx smoke under ``tp`` (expert parallel, at
capacity 8.0) and grok smoke with ``sharding="ffn"`` under ``tp_sp``.
``decode_state_axes`` is held equal to the reference's ``init_decode_state``
axes for every architecture.
"""
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import backbone as rbb

from repro_torch import configs as tconfigs
from repro_torch.dist import model_run
from repro_torch.models import backbone as tbb

import mesh_reference as mr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
BATCH, PROMPT, NEW, KV_LEN = 4, 8, 4, 16
_BASE = dict(kind="decode", batch=BATCH, seq=PROMPT, new=NEW, kv_len=KV_LEN, smoke=True,
             param_dtype="float32", all_positions=True)
CASES = [
    ("starcoder_tp", model_run.Case("starcoder2-3b", mode="tp", **_BASE)),
    ("starcoder_tp_sp", model_run.Case("starcoder2-3b", mode="tp_sp", **_BASE)),
    ("dbrx_tp", model_run.Case("dbrx-132b", mode="tp", capacity_factor=8.0, **_BASE)),
    ("grok_tp_sp", model_run.Case("grok-1-314b", mode="tp_sp", moe_sharding="ffn",
                                  capacity_factor=8.0, **_BASE)),
]
NAMES = [name for name, _ in CASES]


def _reference(d):
    spec = []
    for name, case in CASES:
        spec.append({"name": name, "arch": mr.ARCHS[case.arch], "mode": case.mode,
                     "cf": case.capacity_factor, "sharding": case.moe_sharding,
                     "prompts": os.path.join(d, f"{name}_prompts.npy")})
        np.save(spec[-1]["prompts"], model_run.case_tokens(case))
    mr.run_reference(f"""
        from repro.launch.dryrun import _named
        from repro.models import backbone
        from repro.models.common import spec as axspec
        from repro.serve.serve_step import make_decode_step
        d = {d!r}
        mesh = make_mesh()
        for case in json.loads({json.dumps(json.dumps(spec))}):
            cfg = case_config(case)
            params, paxes = backbone.init_model(jax.random.key(0), cfg)
            np.savez(f"{{d}}/{{case['name']}}_params.npz", **flat(params))
            prompts = np.load(case["prompts"])
            b = prompts.shape[0]
            state, saxes = backbone.init_decode_state(cfg, b, {KV_LEN})
            tok0 = jnp.zeros((b, 1), jnp.int32)
            with axis_rules(make_rules(case["mode"])), jax.set_mesh(mesh):
                p_sh = _named(mesh, paxes, params)
                s_sh = _named(mesh, saxes, state)
                tok_sh = _named(mesh, {{"tokens": axspec("batch", None)}}, {{"tokens": tok0}})
                step = jax.jit(make_decode_step(cfg), in_shardings=(p_sh, s_sh, tok_sh["tokens"], None),
                               out_shardings=(None, s_sh))
                every, toks = [], []
                for t in range(prompts.shape[1]):
                    logits, state = step(params, state, jnp.asarray(prompts[:, t:t + 1]), jnp.int32(t))
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
                out[name] = (case, row, dict(f))
        yield out


@pytest.mark.parametrize("name", NAMES)
def test_mesh_decode_logits_match_reference(runs, name):
    case, row, ref = runs[name]
    assert row["logits_all"].shape == ref["logits"].shape == (
        PROMPT + NEW, BATCH, model_run.case_config(case).padded_vocab)
    np.testing.assert_allclose(row["logits_all"], ref["logits"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(row["logits"], ref["logits"][PROMPT - 1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_decode_greedy_tokens_match_reference(runs, name):
    case, row, ref = runs[name]
    np.testing.assert_array_equal(row["tokens"], ref["tokens"])
    for rank in row["ranks"]:  # every rank sampled the same tokens
        np.testing.assert_array_equal(np.array(rank["tokens"]), ref["tokens"])


@pytest.mark.parametrize("name", NAMES)
def test_mesh_decode_collectives(runs, name):
    """The MoE runs its own collectives at one token a row: the dispatch and
    the return a layer (EP) or none (grok's FFN shards, the tokens whole over
    ``model``), and nothing in decode runs a backward."""
    case, row, _ = runs[name]
    cfg = model_run.case_config(case)
    for rank in row["ranks"]:
        assert rank["backward_collectives"] == {}
        moe = rank["moe_collectives"]
        if cfg.moe is None:
            assert rank["pairs_routed"] == 0 and sum(moe.values()) == 0
        elif case.moe_sharding == "ffn":
            assert moe["all_to_all"] == 0 and rank["pairs_routed"] > 0
        else:  # each generate step, every layer: the dispatch and the return
            assert moe["all_to_all"] == 2 * cfg.n_layers * NEW
        assert rank["pairs_dropped"] == 0


def _plain(tree):
    if isinstance(tree, dict):
        return {key: _plain(sub) for key, sub in tree.items()}
    if isinstance(tree, list):
        return [_plain(sub) for sub in tree]
    return tuple(tree)


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_decode_state_axes_equal_reference(arch):
    _, want = rbb.init_decode_state(rconfigs.get_smoke(arch), 2, KV_LEN)
    cfg = tconfigs.get_smoke(arch)
    got = tbb.decode_state_axes(cfg, 2, KV_LEN)
    assert _plain(got) == _plain(want)
    # the axes name every dimension of the state they describe
    state = tbb.init_decode_state(cfg, 2, KV_LEN, device="meta")
    shapes = torch.utils._pytree.tree_map(lambda t: t.dim(), state)
    dims = torch.utils._pytree.tree_map(len, got, is_leaf=lambda x: isinstance(x, tuple))
    assert shapes == dims
