"""NN primitives of the port: dense, norms, RoPE, embedding.

The PyTorch counterpart of ``repro.models.common``.  Each primitive is a
small ``nn.Module`` whose parameters carry the JAX tree's names (``w``,
``b``, ``scale``, ``bias``), so that ``models.weights.params_from_jax`` is
a name map.  ``Dense.w`` keeps JAX's ``(d_in, d_out)`` layout: ``x @ w`` is
the same product and no transpose hides in the converter.

Parameters are allocated uninitialised; ``reset_parameters(generator)``
draws them from the reference's distributions (``common.py`` ``init_*``).
Each module names the logical axes of its own parameters in ``axes``, the
specs the reference's ``init_*`` return beside the arrays (see
``weights.param_axes``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import (
    axes_of,
    gather_inner,
    grad_as_laid_out,
    grad_placements,
    is_dtensor,
    logical_constraint,
    mesh_sizes,
    placements,
    resolve_spec,
    unstrided,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# ---------------------------------------------------------------- logical axes
# batch/seq: activation dims; embed/ffn/heads/kv/vocab/expert: weight dims.
LOGICAL = ("batch", "seq", "embed", "ffn", "heads", "kv", "vocab", "expert")


class AxisSpec(tuple):
    """Tuple of logical axis names (or None) for one array."""


def spec(*names: str | None) -> AxisSpec:
    return AxisSpec(names)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)``, ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, *, axes: AxisSpec, bias: bool = False, dtype,
                 device) -> None:
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None
        self.axes = {"w": axes, "b": spec(axes[-1])}

    def reset_parameters(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.w.shape[0])
        self.w.uniform_(-scale, scale, generator=generator)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(x):
            x = gather_inner(x)
        y = x @ unstrided(self.w)
        if self.b is not None:
            y = y + unstrided(self.b)
        return grad_as_laid_out(y) if is_dtensor(y) else y


class Norm(nn.Module):
    """LayerNorm or RMSNorm in f32; the output keeps the input's dtype."""

    def __init__(self, d: int, kind: str, *, device, eps: float = 1e-5) -> None:
        super().__init__()
        self.kind = kind
        self.eps = eps
        self.scale = _param((d,), torch.float32, device)
        self.bias = _param((d,), torch.float32, device) if kind == "layernorm" else None
        self.axes = {"scale": spec("embed"), "bias": spec("embed")}

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
        self.axes = {"w": spec("vocab", "embed")}

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.normal_(0.0, 1.0, generator=generator).mul_(0.02)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if is_dtensor(self.w):
            # a vocab-sharded table: DTensor's embedding rule gives partial
            # sums masked by the ids' layout; they are reduced here, while
            # the output still has it (torch 2.11 applies the mask to the
            # re-cut tensor when a later redistribute also cuts the batch)
            from torch.distributed.tensor import Replicate

            out = F.embedding(ids, unstrided(self.w))
            out = out.redistribute(out.device_mesh, [
                Replicate() if p.is_partial() else p for p in out.placements])
            # a gradient arrives partial where no constraint redistributes it
            # first (as on a mesh whose data axis is 1)
            return grad_as_laid_out(out)
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
    """Logical sharding constraint on an activation.

    Resolved through the ambient rules + mesh by
    ``repro_torch.dist.sharding.logical_constraint``: a ``redistribute`` of a
    DTensor under a mesh, a no-op without one (with a one-time warning if
    rules were explicitly set)."""
    return logical_constraint(x, names)


def block_start(mesh, entry, size: int) -> int:
    """Where this rank's block of a ``size``-long dimension laid out as spec
    entry ``entry`` begins (its axes major first, as ``local_slices``)."""
    index, parts = 0, 1
    for axis in axes_of(entry):
        n = mesh_sizes(mesh)[axis]
        index, parts = index * n + mesh.get_local_rank(axis), parts * n
    return index * (size // parts)


class HeadLayout:
    """How a per-rank core over heads lays its inputs out over ``mesh``:
    the heads resolved as the reference's constraint ``(batch, seq, heads,
    None)`` resolves them on the head count, with the sequence whole.

    ``heads`` places a (B, S, H·hd) tensor cut on the rank's heads (whole
    heads only: resolved on H, not on H·hd), ``whole`` a (B, S, ·) tensor
    with every head on every rank, ``h0`` is the rank's first head, and
    ``whole_grad`` the gradient placements of a ``whole`` input: partial
    sums over the axis that splits the heads, since each rank reads only
    its own heads of it (``sharding.grad_placements``)."""

    def __init__(self, mesh, b: int, s: int, n_heads: int, head_dim: int) -> None:
        q_spec = resolve_spec(("batch", None, "heads", None), (b, s, n_heads, head_dim), mesh)
        self.batch, self.head_entry = q_spec[0], q_spec[2]
        self.heads = placements(q_spec[:3], mesh)
        self.whole = placements((q_spec[0], None, None), mesh)
        self.h0 = block_start(mesh, q_spec[2], n_heads)
        self.head_axes = axes_of(q_spec[2])
        self.whole_grad = grad_placements(self.whole, mesh, self.head_axes)
