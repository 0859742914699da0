"""Mamba2 (SSD) block: the chunked state-space recurrence of zamba2.

The PyTorch counterpart of ``repro.models.mamba2``.  The full-sequence form
runs the SSD chunked algorithm (intra-chunk products under a decay mask plus
a recurrence over the chunks' (heads, d_state, head_dim) states); decode
carries the state and costs O(1) per token.  The reference's dtype casts are
kept where they change the arithmetic: its products with
``preferred_element_type=f32`` take f32 inputs here (``_f32``), the decay
weights are cast to the activations' dtype before the products, and decode
keeps its conv window in f32.  The JAX package has no kernel for this block:
it is plain tensor code there and here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, _param, constrain, spec
from .config import ArchConfig


class Mamba2(nn.Module):
    """``in_xz`` (d, 2·d_in), ``in_bc`` (d, 2·d_state), ``in_dt`` (d, heads),
    ``conv`` (d_conv, d_in), ``a_log`` and ``d_skip`` f32 (heads,), ``out``
    (d_in, d)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device) -> None:
        super().__init__()
        d, ssm = cfg.d_model, cfg.ssm
        d_in = d * ssm.expand
        n_heads = d_in // ssm.head_dim
        self.in_xz = Dense(d, 2 * d_in, axes=spec("embed", "ffn"), dtype=dtype, device=device)
        self.in_bc = Dense(d, 2 * ssm.d_state, axes=spec("embed", None), dtype=dtype,
                           device=device)
        self.in_dt = Dense(d, n_heads, axes=spec("embed", "state"), dtype=dtype, device=device)
        self.conv = _param((ssm.d_conv, d_in), dtype, device)
        self.a_log = _param((n_heads,), torch.float32, device)
        self.d_skip = _param((n_heads,), torch.float32, device)
        self.out = Dense(d_in, d, axes=spec("ffn", "embed"), dtype=dtype, device=device)
        self.axes = {"conv": spec(None, "ffn"), "a_log": spec("state"), "d_skip": spec("state")}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``conv`` N(0, 0.02^2) drawn in its dtype, ``a_log`` 0, ``d_skip``
        1; the ``Dense`` layers draw their own."""
        self.conv.normal_(0.0, 1.0, generator=generator).mul_(0.02)
        self.a_log.zero_()
        self.d_skip.fill_(1.0)


def _f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b, preferred_element_type=f32)``: the inputs upcast,
    the product in f32."""
    return torch.einsum(eq, a.float(), b.float())


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv: x (B, S, C), w (K, C), in x's dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def _chunks(s: int, chunk: int) -> tuple[int, int]:
    """(chunks, chunk length): ``max(1, s // chunk)`` equal chunks, where the
    reference's reshape into them fails unless they divide s."""
    nc = max(1, s // chunk)
    if s % nc:
        raise ValueError(f"sequence length {s} does not split into {nc} equal chunks")
    return nc, s // nc


def _ssd_chunked(x, dt, a, b, c, chunk: int) -> torch.Tensor:
    """SSD recurrence: h_t = exp(a·dt_t)·h_{t-1} + dt_t·(b_t ⊗ x_t).

    x (B,S,H,P), dt (B,S,H), a (H) negative, b/c (B,S,N).
    Returns y (B,S,H,P) with y_t = c_t · h_t, in x's dtype.
    """
    bsz, s, h, pdim = x.shape
    n = b.shape[-1]
    nc, ck = _chunks(s, chunk)
    xr = x.reshape(bsz, nc, ck, h, pdim)
    dtr = dt.reshape(bsz, nc, ck, h)
    br = b.reshape(bsz, nc, ck, n)
    cr = c.reshape(bsz, nc, ck, n)

    la = dtr * a[None, None, None, :]  # log decay per step (negative)
    cum = torch.cumsum(la, dim=2)  # (B,nc,ck,H) within-chunk cumulative
    total = cum[:, :, -1, :]  # (B,nc,H)

    # intra-chunk: a causal "attention" under decay weights
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,q,k,H)
    causal = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=x.device))
    # exp(-inf) above the diagonal rather than a masked exp(seg), which
    # overflows past an 88-nat decay and gives NaN gradients (xlstm.py)
    w = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))
    scores = torch.einsum("bnqs,bnks->bnqk", cr, br)  # (B,nc,q,k)
    m_qkh = (scores[..., None] * w * dtr[:, :, None, :, :]).to(x.dtype)
    y_intra = _f32("bnqkh,bnkhp->bnqhp", m_qkh, xr)

    # chunk-final states: sum_k exp(total - cum_k)·dt_k·(b_k ⊗ x_k)
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,ck,H)
    dbx = ((decay_to_end * dtr)[..., None] * xr).to(x.dtype)  # (B,nc,k,H,P)
    chunk_state = _f32("bnks,bnkhp->bnhsp", br.to(x.dtype), dbx)  # (B,nc,H,N,P)

    # inter-chunk recurrence: the state *entering* each chunk
    h_prev = torch.zeros((bsz, h, n, pdim), dtype=torch.float32, device=x.device)
    h_in = []
    for i in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * torch.exp(total[:, i])[:, :, None, None] + chunk_state[:, i]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,N,P)

    # inter-chunk contribution: y += c_q · exp(cum_q) · h_in
    y_inter = _f32("bnqs,bnhsp->bnqhp", cr.to(x.dtype), h_in.to(x.dtype)) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, pdim)
    return y.to(x.dtype)


def mamba2_block(p: Mamba2, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    ssm = cfg.ssm
    d_in = cfg.d_model * ssm.expand
    n_heads = d_in // ssm.head_dim
    bsz, s, _ = x.shape
    xi, z = p.in_xz(x).chunk(2, dim=-1)
    xi = F.silu(_conv1d(xi, p.conv))
    b, c = p.in_bc(x).float().chunk(2, dim=-1)
    dt = F.softplus(p.in_dt(x).float())  # (B,S,H)
    a = -torch.exp(p.a_log)  # (H,)
    xh = xi.reshape(bsz, s, n_heads, ssm.head_dim)
    y = _ssd_chunked(xh, dt, a, b, c, ssm.chunk)
    y = y + xh.float() * p.d_skip[None, None, :, None]
    y = y.reshape(bsz, s, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = constrain(y, "batch", "seq", "ffn")
    return p.out(y)


# ------------------------------------------------------------------ decoding
def mamba2_init_state(cfg: ArchConfig, batch: int, *, layers: int, device,
                      dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Zero states of ``layers`` blocks: ``h`` (layers, B, heads, d_state,
    head_dim) and the conv window ``conv`` (layers, B, d_conv - 1, d_in)."""
    ssm = cfg.ssm
    d_in = cfg.d_model * ssm.expand
    h = d_in // ssm.head_dim
    return {
        "h": torch.zeros((layers, batch, h, ssm.d_state, ssm.head_dim), dtype=dtype,
                         device=device),
        "conv": torch.zeros((layers, batch, ssm.d_conv - 1, d_in), dtype=dtype, device=device),
    }


def mamba2_decode(p: Mamba2, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """One token: x (B,1,D) -> (y, new state {h, conv}).  O(1) in context."""
    ssm = cfg.ssm
    d_in = cfg.d_model * ssm.expand
    n_heads = d_in // ssm.head_dim
    bsz = x.shape[0]
    xi, z = p.in_xz(x).chunk(2, dim=-1)
    window = torch.cat([state["conv"], xi.to(state["conv"].dtype)], dim=1)
    xi = torch.einsum("bkc,kc->bc", window, p.conv.to(window.dtype))[:, None, :]
    new_conv = window[:, 1:, :]
    xi = F.silu(xi)
    b, c = p.in_bc(x).float().chunk(2, dim=-1)  # (B,1,N)
    dt = F.softplus(p.in_dt(x).float())  # (B,1,H)
    a = -torch.exp(p.a_log)
    xh = xi.reshape(bsz, n_heads, ssm.head_dim).float()
    decay = torch.exp(dt[:, 0, :, None, None] * a[None, :, None, None])
    update = torch.einsum("bh,bs,bhp->bhsp", dt[:, 0, :], b[:, 0, :], xh)
    h_new = state["h"] * decay + update
    y = torch.einsum("bs,bhsp->bhp", c[:, 0, :], h_new)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = y * F.silu(z)
    return p.out(y), {"h": h_new, "conv": new_conv}
