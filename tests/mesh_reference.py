"""Helpers of the port's mesh parity tests (``test_torch_mesh_{train,decode}``,
``test_torch_mesh_families{,_train}``).

The reference runs in a subprocess with 8 XLA CPU devices (a ``(data 2,
model 4)`` mesh, as ``tests/test_dist.py`` runs it), and writes its arrays as
``.npz`` files of dotted tree paths (``blocks.attn.wq.w``, stacked layers
whole); :func:`port_arrays` turns such a file into the port's parameter names.
This module imports neither ``jax`` nor ``repro``: the port's ranks, spawned
for :func:`xent_rank`, import it.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"dbrx-132b": "dbrx_132b", "grok-1-314b": "grok_1_314b",
         "starcoder2-3b": "starcoder2_3b", "xlstm-125m": "xlstm_125m",
         "zamba2-1.2b": "zamba2_1p2b", "internvl2-1b": "internvl2_1b",
         "whisper-small": "whisper_small"}

# reference-side helpers, pasted at the top of every subprocess's code
PRELUDE = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke
from repro.dist.sharding import axis_rules, make_rules


def flat(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for key, sub in tree.items():
            flat(sub, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            flat(sub, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def case_config(case):
    cfg = dataclasses.replace(get_smoke(case["arch"]), param_dtype="float32")
    if case.get("remat") is not None:
        cfg = dataclasses.replace(cfg, remat=case["remat"])
    moe = cfg.moe
    if case.get("cf") is not None:
        moe = dataclasses.replace(moe, capacity_factor=case["cf"])
    if case.get("sharding") is not None:
        moe = dataclasses.replace(moe, sharding=case["sharding"])
    return dataclasses.replace(cfg, moe=moe)


def make_mesh(shape=(2, 4)):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
"""


def run_reference(code: str, timeout: int = 900) -> None:
    """Run ``PRELUDE + code`` in a subprocess with 8 XLA CPU devices."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", PRELUDE + textwrap.dedent(code)],
                          capture_output=True, text=True, env=env, timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]


def nest(flat: dict) -> dict:
    """Dotted paths back into a tree of dicts (list indices stay keys)."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def port_arrays(cfg, flat: dict) -> dict:
    """A reference parameter tree (dotted paths) under the port's names."""
    from repro_torch.models.weights import named_arrays

    if cfg.family == "ssm":  # xlstm's blocks are a list: the paths are the names
        return dict(flat)
    return named_arrays(cfg, nest(flat))


def xent_rank(rank: int, world: int, device: str, workdir: str, path: str) -> list:
    """One rank of the vocab-parallel cross-entropy over a (data 2, model 4)
    mesh, on the inputs in ``path``: x replicated, w sharded over ``model``.
    Returns the loss and both gradients, gathered."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.model_run import autograd_fallback_is_an_error
    from repro_torch.dist.sharding import shard_tensor
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.train.xent import vocab_parallel_xent

    mesh = make_model_mesh((2, 4), device_type=device)
    with np.load(path) as f:
        x, w, labels, real = (torch.from_numpy(f[k]) for k in ("x", "w", "labels", "real"))
    xd = shard_tensor(x, mesh, (None, None, None)).requires_grad_(True)
    wd = shard_tensor(w, mesh, ("model", None)).requires_grad_(True)
    with autograd_fallback_is_an_error():
        loss = vocab_parallel_xent(xd, wd, labels, int(real), mesh=mesh, tile=8)
        gx, gw = torch.autograd.grad(loss, [xd, wd])
    return [{"loss": float(loss.detach()), "gx": gx.full_tensor().tolist(),
             "gw": gw.full_tensor().tolist(),
             "gw_on_vocab_shard": gw.placements[1] == Shard(0)}]
