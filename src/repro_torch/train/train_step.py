"""The training step: loss, grads, AdamW update, metrics.

The PyTorch counterpart of ``repro.train.train_step``.  ``make_train_step``
closes over (ArchConfig, TrainConfig) and returns
``train_step(model, opt_state, batch, step) -> (model, opt_state, metrics)``,
which updates the model's parameters and the optimizer state in place.
Gradients come from ``torch.autograd.grad`` (``.grad`` is never used); with
microbatches, each microbatch's gradients are added into an accumulator in
``accum_dtype`` for bf16 parameters (f32 by default, in the parameter's dtype
otherwise) and the sum is divided by the count, as the reference's scan
does.  The forward takes the chunked attention (the flash kernel has no
backward) under the config's ``remat`` policy.

With a ``mesh`` (a ``DeviceMesh`` of the whole world, every rank calling the
step with the same batch) the step lays the model and its optimizer state out
over it at its first call, shards each batch on its tokens and runs under
``use_mesh`` and ``axis_rules``, as the reference's step jitted with its
parameter and optimizer shardings: the loss is the vocab-parallel
cross-entropy over the mesh, and the gradients are redistributed to their
parameters' placements (``_pin_to_specs``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from repro_torch.dist.sharding import (
    Rules,
    ambient_mesh,
    axis_rules,
    current_rules,
    is_dtensor,
    redistribute,
    resolve_spec,
    shard_tensor,
    use_mesh,
)
from repro_torch.models import backbone
from repro_torch.models.config import ArchConfig
from repro_torch.models.weights import (
    opt_state_tree,
    param_axes,
    reference_tree,
    shard_model,
)
from .optimizer import AdamWConfig, adamw_update, init_opt_state, shard_opt_state
from .schedule import ScheduleConfig, learning_rate
from .xent import sharded_xent, vocab_parallel_xent

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    microbatches: int = 1
    moe_aux_weight: float = 0.01
    attn_chunk: int = 512
    fused_xent: bool = True  # tile-fused lm-head + loss
    xent_tile: int = 2048
    accum_dtype: str = "float32"  # grad-accumulation buffer (bf16 for 100B+)
    # over a mesh, pin each microbatch's gradients to their parameters'
    # placements before adding them up (a reduce-scatter each under fsdp);
    # otherwise the sum is pinned once
    shard_grads: bool = True


def loss_fn(model: backbone.Backbone, cfg: ArchConfig, tcfg: TrainConfig, batch: dict):
    """Returns (total loss, {"xent", "moe_aux"}), 0-d f32 tensors."""
    if tcfg.fused_xent:
        hidden, aux = backbone.forward_hidden(model, cfg, batch, chunk=tcfg.attn_chunk,
                                              use_flash=False)
        loss = vocab_parallel_xent(
            hidden,
            backbone.lm_head_weight(model, cfg),
            batch["labels"],
            cfg.vocab,
            mesh=ambient_mesh(),
            token_axes=("pod", "data"),
            tile=tcfg.xent_tile,
            logit_scale=cfg.logit_scale,
        )
    else:
        logits, aux = backbone.forward(model, cfg, batch, chunk=tcfg.attn_chunk,
                                       use_flash=False)
        loss = sharded_xent(logits, batch["labels"], cfg.vocab)
    total = loss + tcfg.moe_aux_weight * aux
    return total, {"xent": loss, "moe_aux": aux}


def _split_micro(batch: dict, n: int) -> list[dict]:
    """n microbatches of consecutive rows (the reference's reshape)."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
    return [{k: v[i * (rows // n):(i + 1) * (rows // n)] for k, v in batch.items()}
            for i in range(n)]


def _value_and_grad(model, params: list, cfg: ArchConfig, tcfg: TrainConfig, batch: dict):
    """The loss, its metrics and one gradient per parameter.  A parameter the
    loss never reads (a GeLU MoE's ``moe.gate``) gets zeros of its own shape
    and dtype, as ``jax.grad`` gives it: it counts in the global norm and
    weight decay still moves it."""
    loss, metrics = loss_fn(model, cfg, tcfg, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _pin_to_specs(grads, params: list) -> list:
    """Each gradient laid out as its parameter (the reference's
    ``with_sharding_constraint`` to the parameter's spec): partial sums are
    reduced, and where the parameter is sharded, reduce-scattered (or, into
    tp2d's ``_StridedShard``, reduced and sliced: ``sharding.redistribute``)."""
    return [redistribute(g, p.placements)
            if is_dtensor(g) and g.placements != p.placements else g
            for g, p in zip(grads, params)]


# the logical axes of a batch's inputs: token ids and labels by default
_BATCH_AXES = {"vis_embeds": ("batch", "seq", "embed"), "frames": ("batch", None, "embed")}


def _shard_batch(batch: dict, mesh, rules: Rules) -> dict:
    """Each tensor of ``batch``, which every rank holds whole, as a DTensor
    laid out on its logical axes: token ids and labels ``("batch",
    "seq")``, the vlm's patches ``("batch", "seq", "embed")``, the audio
    frames ``("batch", None, "embed")`` (the reference's batch axes)."""
    return {key: shard_tensor(val, mesh, resolve_spec(
        _BATCH_AXES.get(key, ("batch", "seq")), val.shape, mesh, rules))
        for key, val in batch.items()}


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, *, mesh=None,
                    rules: Rules | None = None):
    """``train_step(model, opt_state, batch, step) -> (model, opt_state,
    metrics)``.  With ``mesh`` the model and ``opt_state`` are laid out over
    it under ``rules`` (the ambient ones by default) at the first step
    (``weights.shard_model``, ``optimizer.shard_opt_state``), each
    microbatch is sharded on its tokens, and the step runs under
    ``use_mesh(mesh)`` and ``axis_rules(rules)``; the metrics are plain
    tensors, the same on every rank."""
    rules = current_rules() if rules is None else rules

    def grads_of(model, names: list, params: list, batch: dict):
        micro = _split_micro(batch, tcfg.microbatches)
        if mesh is not None:
            micro = [_shard_batch(mb, mesh, rules) for mb in micro]
        adt = _ACCUM_DTYPES[tcfg.accum_dtype]
        acc, losses, per_mb = None, [], []
        for mb in micro:
            loss_mb, metrics_mb, g = _value_and_grad(model, params, cfg, tcfg, mb)
            if len(micro) == 1:
                return loss_mb, metrics_mb, dict(zip(names, _pin_to_specs(g, params)))
            if tcfg.shard_grads:
                g = _pin_to_specs(g, params)
            if acc is None:
                acc = [torch.zeros_like(gi, dtype=adt if gi.dtype == torch.bfloat16 else gi.dtype)
                       for gi in g]
            for a, gi in zip(acc, g):
                a.add_(gi)
            del g
            losses.append(loss_mb)
            per_mb.append(metrics_mb)
        for a in acc:
            a.div_(tcfg.microbatches)
        loss = torch.stack(losses).sum() / tcfg.microbatches
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        return loss, metrics, dict(zip(names, _pin_to_specs(acc, params)))

    def train_step(model: backbone.Backbone, opt_state: dict, batch: dict, step):
        with contextlib.ExitStack() as scope:
            if mesh is not None:
                scope.enter_context(use_mesh(mesh))
                scope.enter_context(axis_rules(rules))
                if not is_dtensor(model.embed.w):
                    shard_model(model, mesh)
                shard_opt_state(opt_state, param_axes(model), mesh)
            named = dict(model.named_parameters())
            frozen = [name for name, p in named.items() if not p.requires_grad]
            if frozen:
                raise ValueError(f"parameters {frozen[:3]}... do not require grad: build the "
                                 "model with init_train_state or call model.requires_grad_(True)")
            names, params = list(named), list(named.values())
            loss, metrics, grads = grads_of(model, names, params, batch)
            lr = learning_rate(step, tcfg.schedule)
            _, opt_state, gnorm = adamw_update(named, grads, opt_state, lr, tcfg.optimizer)
        return model, opt_state, {"loss": loss, "lr": lr, "grad_norm": gnorm, **metrics}

    return train_step


def init_train_state(generator: torch.Generator, cfg: ArchConfig, tcfg: TrainConfig, *,
                     device="cuda"):
    """(model, opt_state): ``backbone.init_model`` drawn from ``generator``
    (which lives on ``device``) with its parameters set to require grad,
    and zero AdamW state.  The reference also returns the logical axis specs:
    here ``weights.param_axes(model)`` and ``optimizer.opt_state_axes`` give
    them, and ``make_train_step(..., mesh=)`` lays both out."""
    model = backbone.init_model(cfg, generator=generator, device=device)
    model.requires_grad_(True)
    return model, init_opt_state(model, tcfg.optimizer)


def train_state(model: backbone.Backbone, opt_state: dict) -> dict:
    """The checkpointed state, ``{"params": ..., "opt": ...}`` in the
    reference's tree (``weights.reference_tree``: each layer stack one
    ``Stack`` leaf, its layers the live tensors, nothing copied), so that a
    checkpoint of it is the reference's byte for byte."""
    cfg = model.cfg
    return {"params": reference_tree(cfg, dict(model.named_parameters())),
            "opt": opt_state_tree(cfg, opt_state)}
