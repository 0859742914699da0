"""Port parity: a training state's checkpoint in the reference's layout.

The reference checkpoints ``{"params": params, "opt": opt}`` as
``jax.tree.flatten`` gives its leaves, each layer stack one ``(L, ...)``
leaf; the port's ``train_state`` gives the same tree, each stack a
``weights.Stack`` of its per-layer tensors.  For five families' smoke
configs, the reference's initial parameters (and seeded AdamW moments, count
7) are carried across with ``params_from_jax``/``opt_state_from_jax``; then
both packages' ``CheckpointManager`` files must be byte-equal (payloads and
``meta.json``), and each package must restore the other's directory, whole
and with ``node_2.bin`` deleted, to equal arrays.  Exact equality throughout.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import train as rtrain
from repro.train import checkpoint as rck

from repro_torch import configs as tconfigs
from repro_torch.models import weights
from repro_torch.train import checkpoint as tck
from repro_torch.train.train_step import train_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["starcoder2-3b", "dbrx-132b", "xlstm-125m", "zamba2-1.2b", "whisper-small"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_state(arch):
    """The reference's initial parameters and seeded moments, as numpy."""
    cfg = rconfigs.get_smoke(arch)
    tcfg = rtrain.TrainConfig(optimizer=rtrain.AdamWConfig(state_dtype=cfg.opt_state_dtype))
    params, opt, _ = rtrain.init_train_state(jax.random.key(0), cfg, tcfg)
    rng = np.random.default_rng(1)
    moment = lambda a: rng.standard_normal(a.shape).astype(a.dtype)  # noqa: E731
    opt = {"m": jax.tree.map(moment, _np(opt["m"])), "v": jax.tree.map(moment, _np(opt["v"])),
           "count": np.array(7, dtype=np.int32)}
    return {"params": _np(params), "opt": opt}


def _port_state(arch, np_state):
    cfg = tconfigs.get_smoke(arch)
    model = weights.params_from_jax(cfg, np_state["params"], device="cpu")
    opt = weights.opt_state_from_jax(cfg, np_state["opt"], device="cpu")
    return model, opt


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _assert_tree_equal(got, want):
    """``got`` (either package's restore, in the reference's tree: numpy
    leaves, or tensors and ``Stack``s) equals the numpy tree ``want`` bit for
    bit, leaf for leaf."""
    g = jax.tree.leaves(got)
    if any(isinstance(x, (torch.Tensor, weights.Stack)) for x in g):
        g = tck._flatten(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(a, weights.Stack):
            a = a.stacked()
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_tree_inverts_named_arrays(arch):
    """``reference_tree`` stacks each ``{stack}.{i}.*`` family back into the
    reference's leaf (xlstm's list stays a list), without copying: a
    ``Stack``'s layers are the model's parameters themselves."""
    np_state = _reference_state(arch)
    cfg = tconfigs.get_smoke(arch)
    named = weights.named_arrays(cfg, np_state["params"])
    tree = weights.reference_tree(cfg, named)
    stacked = jax.tree.map(lambda x: x.stacked() if isinstance(x, weights.Stack) else x, tree,
                           is_leaf=lambda x: isinstance(x, weights.Stack))
    assert jax.tree.structure(stacked) == jax.tree.structure(np_state["params"])
    for a, b in zip(jax.tree.leaves(stacked), jax.tree.leaves(np_state["params"])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    model, opt = _port_state(arch, np_state)
    state = train_state(model, opt)
    live = dict(model.named_parameters())
    for layer in tck.tensors(state["params"]):
        assert any(layer is p for p in live.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_files_equal_reference(arch, tmp_path):
    """Every ``node_<i>.bin`` and ``meta.json`` of the port's save equals the
    reference's save of the same state, byte for byte."""
    np_state = _reference_state(arch)
    model, opt = _port_state(arch, np_state)
    tck.CheckpointManager(str(tmp_path / "port"), device="cpu").save(3, train_state(model, opt))
    rck.CheckpointManager(str(tmp_path / "ref")).save(3, jax.tree.map(jnp.asarray, np_state))
    names = sorted(os.listdir(tmp_path / "ref" / "step_00000003"))
    assert names == sorted(os.listdir(tmp_path / "port" / "step_00000003"))
    assert len(names) == 10
    for name in names:
        with open(tmp_path / "ref" / "step_00000003" / name, "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / "step_00000003" / name, "rb") as f:
            got = f.read()
        assert got == want, name
    with open(tmp_path / "port" / "step_00000003" / "meta.json") as f:
        meta = json.load(f)
    assert [m["shape"] for m in meta["leaves"]] == [
        list(a.shape) for a in jax.tree.leaves(np_state)]


@pytest.mark.parametrize("lose", [False, True], ids=["whole", "node2-lost"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_package_restores_the_other(arch, lose, tmp_path):
    """The reference restores the port's directory and the port the
    reference's, to the saved arrays; with ``node_2.bin`` deleted through the
    layered repair.  The port's restore is then copied into a fresh model in
    place (``copy_state_``) and equals the saved one."""
    np_state = _reference_state(arch)
    model, opt = _port_state(arch, np_state)
    tck.CheckpointManager(str(tmp_path / "port"), device="cpu").save(3, train_state(model, opt))
    jstate = jax.tree.map(jnp.asarray, np_state)
    rck.CheckpointManager(str(tmp_path / "ref")).save(3, jstate)
    if lose:
        for side in ("port", "ref"):
            os.remove(tmp_path / side / "step_00000003" / "node_2.bin")
    mode = "repair" if lose else "direct"
    got, step, report = rck.CheckpointManager(str(tmp_path / "port")).load(jstate)
    assert step == 3 and report.mode == mode
    _assert_tree_equal(_np(got), np_state)
    cfg = tconfigs.get_smoke(arch)
    fresh = weights.Backbone(cfg, device="cpu")
    fresh_opt = weights.opt_state_from_jax(
        cfg, jax.tree.map(np.zeros_like, np_state["opt"]), device="cpu")
    like = train_state(fresh, fresh_opt)
    got, step, report = tck.CheckpointManager(str(tmp_path / "ref"), device="cpu").load(like)
    assert step == 3 and report.mode == mode
    _assert_tree_equal(got, np_state)
    tck.copy_state_(like, got)
    want = tck.state_to_bytes(train_state(model, opt))[0]
    assert torch.equal(tck.state_to_bytes(like)[0], want)
