"""Carry the JAX package's parameters, and its AdamW state, across into the
port's ``Backbone`` and optimizer state.

``params_from_jax(cfg, np_tree)`` takes the reference's parameter tree with
every leaf already a numpy array (``jax.tree.map(np.asarray, params)`` of
``repro.models.backbone.init_model``) and returns a ``Backbone`` holding the
same values, for every family.  The reference stacks the layers of
``blocks``, ``mamba_main``, ``mamba_rem`` and ``encoder`` on a leading axis
(``scan_layers=True``); this splits each into ``{stack}.{i}.*``.  A bf16 leaf
(``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) is viewed as
uint16 and reinterpreted as ``torch.bfloat16``: the bits are copied as they
are, with no f32 round trip.  Only numpy is read here.

``param_axes(model)`` gives each parameter's logical axes, the reference's
``init_model`` axes tree under the same name map; ``shard_model(model,
mesh)`` lays every parameter out over a ``DeviceMesh`` as those axes resolve
under the ambient (or given) rules.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import Rules, resolve_spec, shard_tensor

from .backbone import Backbone
from .common import AxisSpec
from .config import ArchConfig


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# the reference's layer stacks: a dict whose every leaf has a leading layer
# axis (``scan_layers=True``; xlstm's ``blocks`` is a list instead)
STACKED = ("blocks", "mamba_main", "mamba_rem", "encoder")


def named_arrays(cfg: ArchConfig, np_tree: dict) -> dict:
    """The tree's leaves under the port's parameter names: each stacked
    layer axis split into ``{stack}.{i}.*``."""
    out = {}
    for name, leaf in _flatten(np_tree):
        stack, _, rest = name.partition(".")
        if stack in STACKED and isinstance(np_tree[stack], dict):
            for i in range(leaf.shape[0]):
                out[f"{stack}.{i}.{rest}"] = leaf[i]
        else:
            out[name] = leaf
    return out


def params_from_jax(cfg: ArchConfig, np_tree: dict, *, device="cuda") -> Backbone:
    """A ``Backbone`` on ``device`` whose parameters equal ``np_tree``'s."""
    return params_from_arrays(cfg, named_arrays(cfg, np_tree), device=device)


def params_from_arrays(cfg: ArchConfig, arrays: dict, *, device="cuda") -> Backbone:
    """A ``Backbone`` on ``device`` whose parameters equal ``arrays`` (numpy
    arrays under the port's parameter names, as ``named_arrays`` gives)."""
    model = Backbone(cfg, device=device)
    params = dict(model.named_parameters())
    if arrays.keys() != params.keys():
        missing = sorted(params.keys() - arrays.keys())
        extra = sorted(arrays.keys() - params.keys())
        raise ValueError(f"parameter names differ: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, param in params.items():
            src = _to_tensor(arrays[name])
            if src.shape != param.shape or src.dtype != param.dtype:
                raise ValueError(f"{name}: got {src.dtype} {tuple(src.shape)}, "
                                 f"want {param.dtype} {tuple(param.shape)}")
            param.copy_(src)
    return model


def opt_state_from_jax(cfg: ArchConfig, np_opt_state: dict, *, device="cuda") -> dict:
    """The reference's AdamW state (``m``/``v`` trees shaped like the params,
    and ``count``, every leaf a numpy array) as the port's
    ``{"m": {name: tensor}, "v": {name: tensor}, "count"}``: the same name map
    as ``params_from_jax``, the stacked layer axis split, bf16 bits copied as
    they are."""
    out = {}
    for key in ("m", "v"):
        out[key] = {name: _to_tensor(leaf).to(device)
                    for name, leaf in named_arrays(cfg, np_opt_state[key]).items()}
    out["count"] = torch.from_numpy(np.array(np_opt_state["count"], dtype=np.int32)).to(device)
    return out


def param_axes(model: torch.nn.Module) -> dict[str, AxisSpec]:
    """Parameter name -> its logical axes, from each module's ``axes``: the
    reference's ``init_model`` axes tree flattened through the name map of
    ``named_arrays`` (a stacked layer loses its leading ``None``)."""
    out = {}
    for prefix, module in model.named_modules():
        for pname, axes in getattr(module, "axes", {}).items():
            if getattr(module, pname) is not None:
                out[f"{prefix}.{pname}" if prefix else pname] = axes
    names = {name for name, _ in model.named_parameters()}
    if names != out.keys():
        raise ValueError(f"parameters without axes: {sorted(names - out.keys())}")
    return out


def shard_model(model: torch.nn.Module, mesh, rules: Rules | None = None) -> torch.nn.Module:
    """Replace every parameter of ``model`` (in place) by a DTensor over
    ``mesh`` laid out as its logical axes resolve under ``rules`` (the
    ambient ones by default).  Every rank must hold the same full model;
    each keeps its own block of every parameter and nothing is
    communicated."""
    axes = param_axes(model)
    for prefix, module in model.named_modules():
        for pname, param in list(module.named_parameters(recurse=False)):
            name = f"{prefix}.{pname}" if prefix else pname
            spec = resolve_spec(axes[name], param.shape, mesh, rules)
            sharded = shard_tensor(param.detach(), mesh, spec)
            setattr(module, pname, torch.nn.Parameter(sharded, requires_grad=param.requires_grad))
    return model
