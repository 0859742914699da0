"""Plain torch oracles: the GF(2^8) product (mul-table path), a CPU model of
the CUDA kernel's bitsliced arithmetic, and the streaming-softmax attention
recurrence shared by ``flash_attention_ref`` and the model's chunked
attention path."""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.gf_torch import gf_matmul_table

NEG_INF = -1e30

_WORD = 0xFFFFFFFF
# the swap-move stages of the 8 x 8 bit transpose, as ``csrc/gf_matmul.cu``
_SWAP_STAGES = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F))


def gf_matmul_ref(m: torch.Tensor | np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Reference GF(256) product: (R, K) x (K, B) -> (R, B), all uint8."""
    return gf_matmul_table(m, x)


def _transpose8(w: list[torch.Tensor]) -> list[torch.Tensor]:
    """The kernel's bit transpose of 8 words (int64 tensors holding uint32):
    in every byte position, word i gets bit i of each word j at bit j.  It is
    its own inverse."""
    w = list(w)
    for s, mask in _SWAP_STAGES:
        for i in range(8):
            if i & s:
                continue
            t = ((w[i] >> s) ^ w[i + s]) & mask
            w[i + s] = w[i + s] ^ t
            w[i] = w[i] ^ ((t << s) & _WORD)
    return w


def _double(p: list[torch.Tensor]) -> list[torch.Tensor]:
    """x * 2 in plane form, mod 0x11D: the planes shift up by one and plane 7
    feeds planes 0, 2, 3 and 4."""
    return [p[7], p[0], p[1] ^ p[7], p[2] ^ p[7], p[3] ^ p[7], p[4], p[5], p[6]]


def gf_matmul_bitsliced(m: torch.Tensor | np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """GF(256) product (R, K) x (K, B) -> (R, B) uint8, by the CUDA kernel's
    arithmetic, in plain torch on the CPU (tests only; never on the path).

    The payload is cut into 32-byte groups (the last zero-padded), each read
    as 8 little-endian 32-bit words and bit-transposed into 8 planes.  The
    multiples x * 2^i are formed by doubling in plane form; the low nibble of
    a coefficient selects among x .. 8x, the high nibble among 16x .. 128x
    (the kernel doubles its four multiples in place between the two).  Each
    row's 8 accumulator planes are transposed back to bytes at the end.
    """
    m = torch.as_tensor(np.asarray(m, dtype=np.uint8)) if isinstance(m, np.ndarray) else m
    r, k = m.shape
    b = x.shape[1]
    groups = -(-b // 32)
    padded = torch.zeros((k, groups * 32), dtype=torch.uint8)
    padded[:, :b] = x.cpu()
    words = padded.view(k, groups, 8, 4).long()
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    acc = [[torch.zeros((groups,), dtype=torch.long) for _ in range(8)] for _ in range(r)]
    coef = m.cpu().long().tolist()
    for j in range(k):
        mult = [_transpose8([words[j, :, q] for q in range(8)])]
        for _ in range(7):
            mult.append(_double(mult[-1]))
        for row in range(r):
            c = coef[row][j]
            for bit in range(8):
                if c >> bit & 1:
                    acc[row] = [a ^ p for a, p in zip(acc[row], mult[bit])]
    out = torch.empty((r, groups, 8, 4), dtype=torch.uint8)
    for row in range(r):
        back = _transpose8(acc[row])
        for q in range(8):
            for t in range(4):
                out[row, :, q, t] = (back[q] >> (8 * t)) & 0xFF
    return out.view(r, groups * 32)[:, :b].to(x.device)


def _stream_block(m, l, acc, qf, kb, vb, k0: int, causal: bool, p_dtype):
    """One kv block of the recurrence: (m, l, acc) -> (m, l, acc)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
    if causal:
        rows = torch.arange(qf.shape[1], device=qf.device)[:, None]
        cols = k0 + torch.arange(kb.shape[1], device=qf.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    acc = acc * corr + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
    return m_new, l, acc


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
    Where autograd records, each block runs under ``torch.utils.checkpoint``,
    so that backward recomputes a block's scores from its inputs and the
    carry instead of keeping them (the reference's ``jax.checkpoint(body)``).
    """
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, kvh, g, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for k0 in range(0, sk, block):
        kb, vb = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        if remat:
            m, l, acc = torch.utils.checkpoint.checkpoint(
                _stream_block, m, l, acc, qf, kb, vb, k0, causal, p_dtype,
                use_reentrant=False)
        else:
            m, l, acc = _stream_block(m, l, acc, qf, kb, vb, k0, causal, p_dtype)
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4)
