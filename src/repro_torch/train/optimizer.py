"""AdamW with configurable state dtype (bf16 states for the 100B+ MoEs).

The PyTorch counterpart of ``repro.train.optimizer``.  The state mirrors the
parameters by name: ``{"m": {name: tensor}, "v": {name: tensor}, "count"}``,
with the names of ``model.named_parameters()``, so it serializes into the
same erasure-coded checkpoint as the parameters.  ``adamw_update`` writes
the new parameters and moments in place, under ``torch.no_grad``, with the
reference's arithmetic: every step in f32, the result cast back to each
parameter's and moment's dtype.

Over a mesh the moments are DTensors laid out as their parameters
(``opt_state_axes`` gives their logical axes, the parameters'), the global
norm sums each leaf's squares over the ranks that shard it, and the update
runs on each rank's own shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
from torch import nn

from repro_torch.dist import mesh_collectives as mc
from repro_torch.dist.sharding import Rules, is_dtensor, resolve_spec, shard_tensor
from repro_torch.models.common import AxisSpec, spec

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    grad_clip: float = 1.0


def init_opt_state(params: Mapping[str, torch.Tensor] | nn.Module, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter (of a module,
    or of a name -> tensor mapping), laid out as the parameter (a DTensor's
    moments are DTensors with its placements), and a zero int32 step count on
    the parameters' device."""
    named = dict(params.named_parameters() if isinstance(params, nn.Module) else params)
    dt = _STATE_DTYPES[cfg.state_dtype]
    device = next(iter(named.values())).device if named else "cpu"
    return {
        "m": {name: torch.zeros_like(p, dtype=dt) for name, p in named.items()},
        "v": {name: torch.zeros_like(p, dtype=dt) for name, p in named.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_axes(param_axes: Mapping[str, AxisSpec]) -> dict:
    """Logical axes of the optimizer state: the moments mirror the parameters
    (name -> axes, as ``models.weights.param_axes``), the count is a scalar."""
    return {"m": dict(param_axes), "v": dict(param_axes), "count": spec()}


def shard_opt_state(state: dict, param_axes: Mapping[str, AxisSpec], mesh,
                    rules: Rules | None = None) -> dict:
    """Replace the moments of ``state`` (in place) by DTensors over ``mesh``
    laid out as ``opt_state_axes`` resolve under ``rules`` (the ambient ones
    by default).  Every rank must hold the same full state; each keeps its
    own block and nothing is communicated."""
    axes = opt_state_axes(param_axes)
    for key in ("m", "v"):
        for name, full in state[key].items():
            if not is_dtensor(full):
                sp = resolve_spec(axes[key][name], full.shape, mesh, rules)
                state[key][name] = shard_tensor(full, mesh, sp)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (0-d tensor).  A
    DTensor leaf (no partial sums) counts once: its local sum of squares is
    summed over the mesh axes that shard it, one reduction for all the
    leaves sharded over the same axes."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    sq, sharded = [], {}
    for x in leaves:
        if not is_dtensor(x):
            sq.append(torch.sum(torch.square(x.float())))
            continue
        if any(p.is_partial() for p in x.placements):
            raise ValueError("global_norm of partial sums: redistribute the gradients to "
                             "their parameters' placements first")
        axes = tuple(name for name, p in zip(x.device_mesh.mesh_dim_names, x.placements)
                     if not p.is_replicate())  # a Shard or a _StridedShard
        sharded.setdefault((x.device_mesh, axes), []).append(
            torch.sum(torch.square(x.to_local().float())))
    for (mesh, axes), parts in sharded.items():
        sq.append(mc.all_reduce(torch.sum(torch.stack(parts)), mesh, axes))
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if is_dtensor(x) else x


# ``adamw_update`` walks a leaf of more elements than this along its first
# axis, in slices of at least one row, so its f32 temporaries (about 20 bytes
# an element) stay near 0.7 GB or one row, whichever is larger: a whole leaf
# of grok-1's experts would need 32 GB of them, and eight mesh ranks sharing
# one card each hold their own.  The update is elementwise after the global
# norm, so the slices give the same bits as the whole leaf.
UPDATE_SLICE = 2**25


def _leaf_slices(p: torch.Tensor):
    """Index ranges along ``p``'s first axis, each of at most
    ``UPDATE_SLICE`` elements but never less than one row."""
    if p.dim() == 0 or p.numel() <= UPDATE_SLICE:
        return [...]
    rows = max(1, UPDATE_SLICE // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: dict, lr, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, in place.

    ``params`` and ``grads`` map names to tensors, the names of the state's
    moments; ``lr`` is a float or a 0-d f32 tensor.  A DTensor parameter's
    gradient and moments are laid out as it is: after the global norm, the
    elementwise pass runs on each rank's local shards.  Returns
    ``(params, state, grad_norm)``: the same objects, updated.
    """
    if params.keys() != grads.keys():
        raise ValueError(f"grads do not match the parameters: "
                         f"{sorted(params.keys() ^ grads.keys())}")
    for name, p in params.items():
        if is_dtensor(p) and grads[name].placements != p.placements:
            raise ValueError(f"{name}: the gradient is laid out as {grads[name].placements}, "
                             f"the parameter as {p.placements}: redistribute it first")
    state["count"] += 1
    count = state["count"].float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    f32 = dict(dtype=torch.float32, device=count.device)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, **f32), count)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, **f32), count)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for name, leaf in params.items():
        leaf, grad = _local(leaf), _local(grads[name])
        m_leaf, v_leaf = _local(state["m"][name]), _local(state["v"][name])
        for sl in _leaf_slices(leaf):
            p, m, v = leaf[sl], m_leaf[sl], v_leaf[sl]
            g = grad[sl].float() * scale
            m_new = m.float() * cfg.b1 + g * (1 - cfg.b1)
            v_new = v.float() * cfg.b2 + g * (1 - cfg.b2) * g
            del g
            step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            step += p.float() * cfg.weight_decay
            m.copy_(m_new)
            v.copy_(v_new)
            del m_new, v_new
            p.copy_(p.float() - lr * step)
    return params, state, gnorm
