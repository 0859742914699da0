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
backward) under the config's ``remat`` policy.  ``shard_grads`` is a no-op
until sharding is ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.models import backbone
from repro_torch.models.config import ArchConfig
from .optimizer import AdamWConfig, adamw_update, init_opt_state
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
    shard_grads: bool = True  # no-op until sharding is ported


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


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    def train_step(model: backbone.Backbone, opt_state: dict, batch: dict, step):
        named = dict(model.named_parameters())
        frozen = [name for name, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"parameters {frozen[:3]}... do not require grad: build the "
                             "model with init_train_state or call model.requires_grad_(True)")
        names, params = list(named), list(named.values())
        if tcfg.microbatches > 1:
            adt = _ACCUM_DTYPES[tcfg.accum_dtype]
            grads = {name: torch.zeros(p.shape, device=p.device,
                                       dtype=adt if p.dtype == torch.bfloat16 else p.dtype)
                     for name, p in named.items()}
            losses, per_mb = [], []
            for mb in _split_micro(batch, tcfg.microbatches):
                loss_mb, metrics_mb, g = _value_and_grad(model, params, cfg, tcfg, mb)
                for name, gi in zip(names, g):
                    grads[name].add_(gi)
                del g
                losses.append(loss_mb)
                per_mb.append(metrics_mb)
            for acc in grads.values():
                acc.div_(tcfg.microbatches)
            loss = torch.stack(losses).sum() / tcfg.microbatches
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        else:
            loss, metrics, g = _value_and_grad(model, params, cfg, tcfg, batch)
            grads = dict(zip(names, g))
        lr = learning_rate(step, tcfg.schedule)
        _, opt_state, gnorm = adamw_update(named, grads, opt_state, lr, tcfg.optimizer)
        return model, opt_state, {"loss": loss, "lr": lr, "grad_norm": gnorm, **metrics}

    return train_step


def init_train_state(generator: torch.Generator, cfg: ArchConfig, tcfg: TrainConfig, *,
                     device="cuda"):
    """(model, opt_state): ``backbone.init_model`` drawn from ``generator``
    (which lives on ``device``) with its parameters set to require grad,
    and zero AdamW state.  The reference also returns the logical axis specs,
    which wait for the sharding port."""
    model = backbone.init_model(cfg, generator=generator, device=device)
    model.requires_grad_(True)
    return model, init_opt_state(model, tcfg.optimizer)


def train_state(model: backbone.Backbone, opt_state: dict) -> dict:
    """The checkpointed state: ``{"params": {name: tensor}, "opt": opt_state}``."""
    return {"params": dict(model.named_parameters()), "opt": opt_state}
