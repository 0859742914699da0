"""Plain torch oracles: the GF(2^8) product (mul-table path) and the
streaming-softmax attention recurrence shared by ``flash_attention_ref`` and
the model's chunked attention path."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gf_torch import gf_matmul_table

NEG_INF = -1e30


def gf_matmul_ref(m: torch.Tensor | np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Reference GF(256) product: (R, K) x (K, B) -> (R, B), all uint8."""
    return gf_matmul_table(m, x)


def streaming_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    block: int,
    p_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The flash recurrence in f32: q (B, Sq, kvH, G, D), already scaled;
    k/v (B, Sk, kvH, D) -> (B, Sq, kvH, G, D) in f32.

    Walks Sk in blocks of ``block`` (the last may be short) keeping the
    running (max, sum, acc); masked scores are ``-1e30`` (positions from 0
    for q and k, ``row >= col`` kept) and the output is
    ``acc / max(l, 1e-30)``.  ``p_dtype`` rounds P to that dtype before the
    PV product (``l`` sums the unrounded P); None keeps it in f32.  GQA
    groups ride on the G axis: repeated K/V is never built.
    """
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, kvh, g, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, block):
        kb, vb = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
        if causal:
            cols = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * corr + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4)
