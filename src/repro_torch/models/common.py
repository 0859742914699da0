"""NN primitives of the port: dense, norms, RoPE, embedding.

The PyTorch counterpart of ``repro.models.common``.  Each primitive is a
small ``nn.Module`` whose parameters carry the JAX tree's names (``w``,
``b``, ``scale``, ``bias``), so that ``models.weights.params_from_jax`` is
a name map.  ``Dense.w`` keeps JAX's ``(d_in, d_out)`` layout: ``x @ w`` is
the same product and no transpose hides in the converter.

Parameters are allocated uninitialised; ``reset_parameters(generator)``
draws them from the reference's distributions (``common.py`` ``init_*``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)``, ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False, dtype, device) -> None:
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.w.shape[0])
        self.w.uniform_(-scale, scale, generator=generator)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        if self.b is not None:
            y = y + self.b
        return y


class Norm(nn.Module):
    """LayerNorm or RMSNorm in f32; the output keeps the input's dtype."""

    def __init__(self, d: int, kind: str, *, device, eps: float = 1e-5) -> None:
        super().__init__()
        self.kind = kind
        self.eps = eps
        self.scale = _param((d,), torch.float32, device)
        self.bias = _param((d,), torch.float32, device) if kind == "layernorm" else None

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            mu = xf.mean(dim=-1, keepdim=True)
            var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var
            y = (xf - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        else:  # rmsnorm
            ms = (xf * xf).mean(dim=-1, keepdim=True)
            y = xf * torch.rsqrt(ms + self.eps) * self.scale
        return y.to(x.dtype)


class Embedding(nn.Module):
    """Token table ``w`` of shape ``(vocab, d)``."""

    def __init__(self, vocab: int, d: int, *, dtype, device) -> None:
        super().__init__()
        self.w = _param((vocab, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.normal_(0.0, 1.0, generator=generator).mul_(0.02)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w[ids.long()]


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim/2), in f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(theta, exps)  # a Python base: no host-to-device copy
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def constrain(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Logical sharding constraint: a no-op until sharding is ported."""
    return x
