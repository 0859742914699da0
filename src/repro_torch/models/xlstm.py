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

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import (
    ambient_mesh,
    axes_of,
    grad_placements,
    is_dtensor,
    placements,
    resolve_spec,
    unstrided,
)

from .common import Dense, HeadLayout, spec
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


def _local_mlstm(q2, k2, v2, zf, zi, *, cfg: ArchConfig, h0: int, chunk: int) -> torch.Tensor:
    """One rank's mLSTM: q2/k2/v2 (B, S, Hl·hd) its heads h0..h0+Hl, zf/zi
    (B, S, H) every head's f32 gate products, of which it reads its own."""
    b, s, _ = q2.shape
    hd = cfg.head_dim
    hl = q2.shape[-1] // hd
    q = q2.reshape(b, s, hl, hd)
    k = _inv_sqrt_scaled(k2.reshape(b, s, hl, hd), hd)
    v = v2.reshape(b, s, hl, hd)
    log_f = F.logsigmoid(zf[..., h0:h0 + hl])
    log_i = -F.softplus(-zi[..., h0:h0 + hl])  # log sigmoid for stability
    y = _mlstm_chunked(q, k, v, log_f, log_i, chunk)
    return y.reshape(b, s, hl * hd)


def mlstm_block(p: MLSTM, cfg: ArchConfig, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """The mLSTM over x (B, S, d).  Of a DTensor x under an ambient mesh, the
    projections are DTensor products and the recurrence runs per rank in
    ``local_map`` over the rank's heads (``HeadLayout``, as attention's):
    the replicated f32 gates ``wi``/``wf`` give every head's, and each rank
    reads its own; ``wo``'s partial sums are reduced by the next
    constraint."""
    b, s, _ = x.shape
    zf, zi = _gate(p.wf, x), _gate(p.wi, x)
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        y = _local_mlstm(p.wq(x), p.wk(x), p.wv(x), zf, zi, cfg=cfg, h0=0, chunk=chunk)
        return p.wo(y)
    from torch.distributed.tensor.experimental import local_map

    lay = HeadLayout(mesh, b, s, cfg.n_heads, cfg.head_dim)
    core = local_map(
        functools.partial(_local_mlstm, cfg=cfg, h0=lay.h0, chunk=chunk),
        out_placements=list(lay.heads), device_mesh=mesh, redistribute_inputs=True,
        in_placements=(lay.heads,) * 3 + (lay.whole,) * 2,
        in_grad_placements=(lay.heads,) * 3 + (lay.whole_grad,) * 2)
    return p.wo(core(p.wq(x), p.wk(x), p.wv(x), zf, zi))


def mlstm_init_state(cfg: ArchConfig, batch: int, *, device) -> dict[str, torch.Tensor]:
    h, hd = cfg.n_heads, cfg.head_dim
    return {"c": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device)}


def _local_mlstm_decode(q2, k2, v2, zf, zi, c, *, cfg: ArchConfig, h0: int):
    """One rank's mLSTM step: q2/k2/v2 (B, 1, Hl·hd) its heads, zf/zi (B,
    1, H) every head's gate products, c (B, Hl, hd, hd) its heads' memory.
    Returns (y (B, 1, Hl·hd), the new memory)."""
    b = q2.shape[0]
    hd = cfg.head_dim
    hl = q2.shape[-1] // hd
    q = q2.reshape(b, hl, hd)
    k = _inv_sqrt_scaled(k2.reshape(b, hl, hd), hd)
    v = v2.reshape(b, hl, hd)
    f, i = torch.sigmoid(zf[:, 0, h0:h0 + hl]), torch.sigmoid(zi[:, 0, h0:h0 + hl])
    c = c * f[:, :, None, None] + i[:, :, None, None] * torch.einsum(
        "bhd,bhe->bhde", k.float(), v.float())
    y = torch.einsum("bhd,bhde->bhe", q.float(), c)
    norm = torch.clamp(y.sum(dim=-1, keepdim=True).abs(), min=1.0)
    return (y / norm).reshape(b, 1, hl * hd).to(q2.dtype), c


def mlstm_decode(p: MLSTM, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """One token.  Under an ambient mesh (x a DTensor) each rank steps its
    own heads of the memory, laid out ``("batch", "heads", None, None)`` as
    ``backbone.decode_state_axes`` says."""
    f, i = _gate(p.wf, x), _gate(p.wi, x)
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        y, c = _local_mlstm_decode(p.wq(x), p.wk(x), p.wv(x), f, i, state["c"], cfg=cfg, h0=0)
        return p.wo(y), {"c": c}
    from torch.distributed.tensor.experimental import local_map

    lay = HeadLayout(mesh, x.shape[0], 1, cfg.n_heads, cfg.head_dim)
    c_pl = state["c"].placements  # ("batch", "heads", None, None)
    y, c = local_map(
        functools.partial(_local_mlstm_decode, cfg=cfg, h0=lay.h0),
        out_placements=(lay.heads, c_pl), device_mesh=mesh, redistribute_inputs=True,
        in_placements=(lay.heads,) * 3 + (lay.whole,) * 2 + (c_pl,),
    )(p.wq(x), p.wk(x), p.wv(x), f, i, state["c"])
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


def _slstm_step(wh: torch.Tensor, carry, zx: torch.Tensor):
    """One time step from ``zx = wx(x_t)``: the input projection is the same
    product for every step, so ``slstm_block`` makes it once for all."""
    h_prev, c_prev, n_prev = carry
    z = zx + h_prev @ wh
    zi, zf, zo, zc = z.float().chunk(4, dim=-1)
    i = torch.exp(torch.clamp(zi, max=8.0))  # exponential input gate (capped)
    f = torch.sigmoid(zf)
    o = torch.sigmoid(zo)
    c = f * c_prev + i * torch.tanh(zc)
    n = f * n_prev + i
    h = (o * c / torch.clamp(n, min=1.0)).to(zx.dtype)
    return (h, c, n), h


def _slstm_scan(zx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The recurrence over zx (B, S, 4d) from a zero carry: the hidden
    states (B, S, d)."""
    b, _, d4 = zx.shape
    f32 = dict(dtype=torch.float32, device=zx.device)
    carry = (zx.new_zeros((b, d4 // 4)), torch.zeros((b, d4 // 4), **f32),
             torch.zeros((b, d4 // 4), **f32))
    ys = []
    for t in range(zx.shape[1]):
        carry, h = _slstm_step(wh, carry, zx[:, t])
        ys.append(h)
    return torch.stack(ys, dim=1)


def _whole_gates(mesh, zx) -> tuple:
    """The placements of zx (B, S, 4d) with every gate and position on every
    rank of its rows, of ``wh`` whole, and of ``wh``'s gradient: partial
    sums over the axes that split the rows."""
    spec = resolve_spec(("batch", None, None), zx.shape, mesh)
    whole_w = placements((None, None), mesh)
    return placements(spec, mesh), whole_w, grad_placements(whole_w, mesh, axes_of(spec[0]))


def slstm_block(p: SLSTM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM over x (B, S, d).  Under an ambient mesh ``wx`` and ``wh``
    are ``ffn``-sharded over 4d, so a rank holds some gates and the step
    needs all four: ``wx``'s product and ``wh`` are gathered once a block and
    each rank runs the whole recurrence on its rows (in ``local_map``, the
    reference's arithmetic), where a collective a step would cost thousands
    a forward; ``wh``'s gradient goes back through the gather's transpose."""
    zx = p.wx(x)
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return p.out(_slstm_scan(zx, p.wh.w))
    from torch.distributed.tensor.experimental import local_map

    zx_pl, wh_pl, wh_grad = _whole_gates(mesh, zx)
    hs = local_map(_slstm_scan, out_placements=list(zx_pl), in_placements=(zx_pl, wh_pl),
                   in_grad_placements=(zx_pl, wh_grad), device_mesh=mesh,
                   redistribute_inputs=True)(zx, unstrided(p.wh.w))
    return p.out(hs)


def slstm_init_state(cfg: ArchConfig, batch: int, dtype, *, device) -> dict[str, torch.Tensor]:
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=dtype, device=device),
        "c": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
    }


def _slstm_decode_step(zx, wh, h, c, n):
    (h, c, n), y = _slstm_step(wh, (h, c, n), zx[:, 0])
    return y[:, None, :], h, c, n


def slstm_decode(p: SLSTM, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """One token.  Under an ambient mesh each rank steps the whole state of
    its rows, as ``slstm_block`` does, from the gathered gates; the state
    keeps the layout of ``backbone.decode_state_axes``."""
    zx = p.wx(x)
    carry = (state["h"], state["c"], state["n"])
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        y, h, c, n = _slstm_decode_step(zx, p.wh.w, *carry)
        return p.out(y), {"h": h, "c": c, "n": n}
    from torch.distributed.tensor.experimental import local_map

    zx_pl, wh_pl, _ = _whole_gates(mesh, zx)
    row_pl = state["h"].placements  # ("batch", "embed"): the rows' axes, embed whole
    y, h, c, n = local_map(
        _slstm_decode_step, out_placements=(zx_pl,) + (row_pl,) * 3,
        in_placements=(zx_pl, wh_pl) + (row_pl,) * 3, device_mesh=mesh,
        redistribute_inputs=True)(zx, unstrided(p.wh.w), *carry)
    return p.out(y), {"h": h, "c": c, "n": n}
