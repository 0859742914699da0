"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The PyTorch counterpart of ``repro.models.xlstm``.  mLSTM runs in the
chunked form (intra-chunk products under a decay mask, a recurrence over
the chunks' (d_k, d_v) memories); sLSTM is sequential and walks the time
axis.  Both decode in O(1) per token.  The input and forget gate weights
``wi``/``wf`` are f32 while the activations may be bf16: JAX promotes the
product to f32, ``torch.matmul`` refuses mixed dtypes, so x is upcast for
them.  ``k`` is divided by sqrt(head_dim) rounded to the activations' dtype,
as the reference's ``jnp.sqrt(hd).astype(x.dtype)``.  The JAX package has no
kernel for these blocks: they are plain tensor code there and here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, constrain, spec
from .config import ArchConfig
from .mamba2 import _chunks, _f32


# ------------------------------------------------------------------- mLSTM
class MLSTM(nn.Module):
    """``wq``, ``wk``, ``wv`` (d, H·hd), ``wi``, ``wf`` f32 (d, H), ``wo`` (d, d)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device) -> None:
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = Dense(d, h * hd, axes=spec("embed", "heads"), **kw)
        self.wk = Dense(d, h * hd, axes=spec("embed", "heads"), **kw)
        self.wv = Dense(d, h * hd, axes=spec("embed", "heads"), **kw)
        self.wi = Dense(d, h, axes=spec("embed", "state"), dtype=torch.float32, device=device)
        self.wf = Dense(d, h, axes=spec("embed", "state"), dtype=torch.float32, device=device)
        self.wo = Dense(d, d, axes=spec("heads", "embed"), **kw)


def _gate(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """An f32 gate projection of x in any dtype (x upcast, as JAX promotes)."""
    return p(x.float())


def _inv_sqrt_scaled(k: torch.Tensor, hd: int) -> torch.Tensor:
    """k / sqrt(hd), the root computed in f32 and rounded to k's dtype."""
    return k / torch.tensor(float(hd), dtype=torch.float32).sqrt().to(k.dtype)


def _mlstm_chunked(q, k, v, log_f, log_i, chunk: int) -> torch.Tensor:
    """Chunked mLSTM: C_t = f_t·C_{t-1} + i_t·(k_t ⊗ v_t); y_t = q_t·C_t.

    q/k/v (B,S,H,D); log_f/log_i (B,S,H).  Normalization follows the
    max-state stabilizer in a simplified form (denominator |q·n| + 1).
    """
    b, s, h, d = q.shape
    nc, ck = _chunks(s, chunk)
    qr = q.reshape(b, nc, ck, h, d)
    kr = k.reshape(b, nc, ck, h, d)
    vr = v.reshape(b, nc, ck, h, d)
    lf = log_f.reshape(b, nc, ck, h)
    li = log_i.reshape(b, nc, ck, h)
    cum = torch.cumsum(lf, dim=2)
    total = cum[:, :, -1, :]

    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # decay q<-k
    causal = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=q.device))
    # exp of -inf above the diagonal, not exp(seg) masked after: seg there is
    # -(the decay between k and q), whose exp overflows past an 88-nat decay,
    # and the masked inf gives 0 * inf = NaN gradients (the reference's
    # ``where(causal, exp(...), 0)`` has that fault); the forward is the same
    w = torch.exp(torch.where(causal[None, None, :, :, None], seg + li[:, :, None, :, :],
                              float("-inf")))
    scores = torch.einsum("bnqhd,bnkhd->bnqkh", qr, kr)
    m_qkh = (scores * w).to(q.dtype)
    y_intra = _f32("bnqkh,bnkhd->bnqhd", m_qkh, vr)

    decay_to_end = torch.exp(total[:, :, None, :] - cum + li)
    kd = (decay_to_end[..., None] * kr).to(q.dtype)  # (B,nc,k,H,Dk)
    chunk_state = _f32("bnkhd,bnkhe->bnhde", kd, vr)  # (B,nc,H,Dk,Dv)

    c_prev = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    c_in = []
    for i in range(nc):  # the memory entering each chunk
        c_in.append(c_prev)
        c_prev = c_prev * torch.exp(total[:, i])[:, :, None, None] + chunk_state[:, i]
    c_in = torch.stack(c_in, dim=1)
    qd = (qr * torch.exp(cum)[..., None]).to(q.dtype)
    y_inter = _f32("bnqhd,bnhde->bnqhe", qd, c_in.to(q.dtype))
    y = (y_intra + y_inter).reshape(b, s, h, d)
    norm = torch.clamp(y.sum(dim=-1, keepdim=True).abs(), min=1.0)
    return (y / norm).to(q.dtype)


def mlstm_block(p: MLSTM, cfg: ArchConfig, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = p.wq(x).reshape(b, s, h, hd)
    k = _inv_sqrt_scaled(p.wk(x).reshape(b, s, h, hd), hd)
    v = p.wv(x).reshape(b, s, h, hd)
    log_f = F.logsigmoid(_gate(p.wf, x))
    log_i = -F.softplus(-_gate(p.wi, x))  # log sigmoid for stability
    y = _mlstm_chunked(q, k, v, log_f, log_i, chunk)
    y = constrain(y, "batch", "seq", "heads", None)
    return p.wo(y.reshape(b, s, h * hd))


def mlstm_init_state(cfg: ArchConfig, batch: int, *, device) -> dict[str, torch.Tensor]:
    h, hd = cfg.n_heads, cfg.head_dim
    return {"c": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device)}


def mlstm_decode(p: MLSTM, cfg: ArchConfig, x: torch.Tensor, state: dict):
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    q = p.wq(x).reshape(b, h, hd)
    k = _inv_sqrt_scaled(p.wk(x).reshape(b, h, hd), hd)
    v = p.wv(x).reshape(b, h, hd)
    f = torch.sigmoid(_gate(p.wf, x))[:, 0, :]
    i = torch.sigmoid(_gate(p.wi, x))[:, 0, :]
    c = state["c"] * f[:, :, None, None] + i[:, :, None, None] * torch.einsum(
        "bhd,bhe->bhde", k.float(), v.float())
    y = torch.einsum("bhd,bhde->bhe", q.float(), c)
    norm = torch.clamp(y.sum(dim=-1, keepdim=True).abs(), min=1.0)
    y = (y / norm).reshape(b, 1, h * hd).to(x.dtype)
    return p.wo(y), {"c": c}


# ------------------------------------------------------------------- sLSTM
class SLSTM(nn.Module):
    """``wx``, ``wh`` (d, 4d) for the gates [i, f, o, c], ``out`` (d, d)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device) -> None:
        super().__init__()
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.wx = Dense(d, 4 * d, axes=spec("embed", "ffn"), **kw)
        self.wh = Dense(d, 4 * d, axes=spec("embed", "ffn"), **kw)
        self.out = Dense(d, d, axes=spec("embed", "embed"), **kw)


def _slstm_step(p: SLSTM, carry, zx: torch.Tensor):
    """One time step from ``zx = wx(x_t)``: the input projection is the same
    product for every step, so ``slstm_block`` makes it once for all."""
    h_prev, c_prev, n_prev = carry
    z = zx + p.wh(h_prev)
    zi, zf, zo, zc = z.float().chunk(4, dim=-1)
    i = torch.exp(torch.clamp(zi, max=8.0))  # exponential input gate (capped)
    f = torch.sigmoid(zf)
    o = torch.sigmoid(zo)
    c = f * c_prev + i * torch.tanh(zc)
    n = f * n_prev + i
    h = (o * c / torch.clamp(n, min=1.0)).to(zx.dtype)
    return (h, c, n), h


def slstm_block(p: SLSTM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    carry = (x.new_zeros((b, d)),
             torch.zeros((b, d), dtype=torch.float32, device=x.device),
             torch.zeros((b, d), dtype=torch.float32, device=x.device))
    zx = p.wx(x)
    ys = []
    for t in range(s):
        carry, h = _slstm_step(p, carry, zx[:, t])
        ys.append(h)
    return p.out(torch.stack(ys, dim=1))


def slstm_init_state(cfg: ArchConfig, batch: int, dtype, *, device) -> dict[str, torch.Tensor]:
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=dtype, device=device),
        "c": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
    }


def slstm_decode(p: SLSTM, cfg: ArchConfig, x: torch.Tensor, state: dict):
    carry = (state["h"], state["c"], state["n"])
    (h, c, n), y = _slstm_step(p, carry, p.wx(x[:, 0, :]))
    return p.out(y)[:, None, :], {"h": h, "c": c, "n": n}
