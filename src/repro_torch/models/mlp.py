"""Feed-forward blocks: SwiGLU / GeLU.

The PyTorch counterpart of ``repro.models.mlp``.  The token-choice MoE layer
is not ported yet (ROADMAP, "What is left": MoE, SSM, hybrid, VLM and audio).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, constrain

MOE_NOT_PORTED = "the MoE layer is not ported yet (ROADMAP: MoE, SSM, hybrid, VLM and audio)"


class MLP(nn.Module):
    """Weights of ``mlp``: ``up``, ``down``, and ``gate`` for SwiGLU."""

    def __init__(self, d: int, d_ff: int, act: str, *, dtype, device) -> None:
        super().__init__()
        self.up = Dense(d, d_ff, dtype=dtype, device=device)
        self.gate = Dense(d, d_ff, dtype=dtype, device=device) if act == "swiglu" else None
        self.down = Dense(d_ff, d, dtype=dtype, device=device)


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    h = p.up(x)
    if act == "swiglu":
        h = F.silu(p.gate(x)) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    h = constrain(h, "batch", "seq", "ffn")
    return p.down(h)
