"""LR schedules: cosine and WSD (warmup-stable-decay, minicpm §4).

The PyTorch counterpart of ``repro.train.schedule``.  Every value is
computed in f32 in the reference's order of operations, with Python
constants rounded to f32 where ``jnp`` rounds its weak-typed scalars.  Only
``cos``, ``exp`` and ``log`` differ: each library has its own f32
approximation, an ulp apart, which the cosine's ``1 + cos`` near its end
magnifies to a few ulps of the rate (within 1e-6 relative).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_F32 = torch.float32


@dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"  # cosine | wsd | constant
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1  # WSD: last 10% of steps decay
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def learning_rate(step, cfg: ScheduleConfig) -> torch.Tensor:
    """The rate at ``step`` (an int or a 0-d tensor) as a 0-d f32 tensor on
    the CPU."""
    step = torch.as_tensor(step).to(device="cpu", dtype=_F32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1)), max=1.0)
    if cfg.kind == "constant":
        return _f32(cfg.peak_lr) * warm
    if cfg.kind == "cosine":
        t = torch.clamp((step - _f32(cfg.warmup_steps))
                        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
        cos = _f32(0.5) * (_f32(1.0) + torch.cos(_f32(math.pi) * t))
        frac = _f32(cfg.min_lr_frac) + _f32(1 - cfg.min_lr_frac) * cos
        return _f32(cfg.peak_lr) * warm * frac
    if cfg.kind == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
        t = torch.clamp((step - _f32(decay_start))
                        / _f32(max(cfg.total_steps - decay_start, 1)), 0.0, 1.0)
        # exponential-ish decay to min_lr_frac (minicpm uses 10x drop)
        frac = torch.exp(torch.log(_f32(cfg.min_lr_frac)) * t)
        return _f32(cfg.peak_lr) * warm * frac
    raise ValueError(cfg.kind)
