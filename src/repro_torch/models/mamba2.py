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

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import mesh_collectives as mc
from repro_torch.dist.sharding import (
    ambient_mesh,
    axes_of,
    grad_placements,
    is_dtensor,
    placements,
    resolve_spec,
    unstrided,
)

from .common import Dense, _param, block_start, constrain, spec
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


def _local_mamba(xz, bc, dt_raw, conv, a_log, d_skip, *, cfg: ArchConfig,
                 c0: int) -> torch.Tensor:
    """One rank's Mamba2 over its channels c0..c0+C (C = ``conv``'s, whole
    heads): xz (B, S, 2·d_in) the fused input product with every channel of
    x and z, bc (B, S, 2·d_state) and dt_raw (B, S, heads) whole.  Returns
    the gated y (B, S, C)."""
    ssm = cfg.ssm
    bsz, s, _ = xz.shape
    d_in, cl = xz.shape[-1] // 2, conv.shape[-1]
    h0, hl = c0 // ssm.head_dim, cl // ssm.head_dim
    xi, z = xz[..., c0:c0 + cl], xz[..., d_in + c0:d_in + c0 + cl]
    xi = F.silu(_conv1d(xi, conv))
    b, c = bc.float().chunk(2, dim=-1)
    dt = F.softplus(dt_raw[..., h0:h0 + hl].float())  # (B,S,Hl)
    a = -torch.exp(a_log[h0:h0 + hl])  # (Hl,)
    xh = xi.reshape(bsz, s, hl, ssm.head_dim)
    y = _ssd_chunked(xh, dt, a, b, c, ssm.chunk)
    y = y + xh.float() * d_skip[h0:h0 + hl][None, None, :, None]
    y = y.reshape(bsz, s, cl).to(xz.dtype)
    return y * F.silu(z)


def mamba2_block(p: Mamba2, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The Mamba2 block over x (B, S, d).

    Under an ambient mesh (x a DTensor) the input products are DTensor
    products and the rest runs per rank in ``local_map`` over a block of
    whole heads, laid out as ``ffn`` resolves on the head count (the axes
    the tokens do not use).  The fused ``in_xz`` is sharded over ``ffn``
    across x's and z's columns alike, so under model 4 ranks 0-1 would hold
    x and ranks 2-3 z: its product is gathered whole (the rank then takes x
    and z of its own channels) rather than the weight, which its gradient
    would have to be reduced into whole too.  ``in_bc``, ``in_dt``,
    ``a_log`` and ``d_skip`` are read whole, each rank its heads; the
    output product's partial sums are reduced by the next constraint."""
    xz, bc, dt_raw = p.in_xz(x), p.in_bc(x), p.in_dt(x)
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        y = _local_mamba(xz, bc, dt_raw, p.conv, p.a_log, p.d_skip, cfg=cfg, c0=0)
        return p.out(y)
    from torch.distributed.tensor.experimental import local_map

    ssm = cfg.ssm
    b, s, _ = x.shape
    d_in = cfg.d_model * ssm.expand
    spec_ = resolve_spec(("batch", None, "ffn"), (b, s, d_in // ssm.head_dim), mesh)
    whole = placements((spec_[0], None, None), mesh)
    chans = placements(spec_, mesh)
    conv_pl, vec_pl = placements((None, spec_[2]), mesh), placements((None,), mesh)
    # a rank reads its channels of the whole inputs: their gradients are
    # partial over the channels' axes, the weights' over the tokens' too
    varying = axes_of(spec_[0]) + axes_of(spec_[2])
    in_pl = (whole, whole, whole, conv_pl, vec_pl, vec_pl)
    y = local_map(
        functools.partial(_local_mamba, cfg=cfg, c0=block_start(mesh, spec_[2], d_in)),
        out_placements=list(chans), in_placements=in_pl, device_mesh=mesh,
        in_grad_placements=tuple(grad_placements(pl, mesh, varying) for pl in in_pl),
        redistribute_inputs=True)(xz, bc, dt_raw, unstrided(p.conv), p.a_log, p.d_skip)
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


def _local_mamba_decode(xz, bc, dt_raw, conv, a_log, d_skip, conv_state, h_state, *,
                        cfg: ArchConfig, c0: int, gather=None) -> torch.Tensor:
    """One rank's Mamba2 step: xz (B, 1, 2·d_in) every channel, its channels
    c0..c0+C of the conv weight and of the conv window ``conv_state`` (B,
    d_conv - 1, C), every head's ``h_state``; both states written in place.
    ``gather`` brings the rank's conv outputs (B, 1, C) together into every
    channel's, from which each rank steps every head, so ``h_state`` stays
    alike on every rank.  Returns the gated y of its channels (B, 1, C)."""
    ssm = cfg.ssm
    bsz = xz.shape[0]
    d_in, cl = xz.shape[-1] // 2, conv.shape[-1]
    n_heads = d_in // ssm.head_dim
    window = torch.cat([conv_state, xz[..., c0:c0 + cl].to(conv_state.dtype)], dim=1)
    xi = torch.einsum("bkc,kc->bc", window, conv.to(window.dtype))[:, None, :]
    conv_state.copy_(window[:, 1:, :])
    xi = F.silu(xi)
    if gather is not None:
        xi = gather(xi)
    b, c = bc.float().chunk(2, dim=-1)  # (B,1,N)
    dt = F.softplus(dt_raw.float())  # (B,1,H)
    a = -torch.exp(a_log)
    xh = xi.reshape(bsz, n_heads, ssm.head_dim).float()
    decay = torch.exp(dt[:, 0, :, None, None] * a[None, :, None, None])
    update = torch.einsum("bh,bs,bhp->bhsp", dt[:, 0, :], b[:, 0, :], xh)
    h_state.copy_(h_state * decay + update)
    y = torch.einsum("bs,bhsp->bhp", c[:, 0, :], h_state)
    y = y + xh * d_skip[None, :, None]
    y = y.reshape(bsz, 1, d_in)[..., c0:c0 + cl].to(xz.dtype)
    return y * F.silu(xz[..., d_in + c0:d_in + c0 + cl])


def _gather_channels(t: torch.Tensor, mesh, entry) -> torch.Tensor:
    """t (B, 1, C) of every rank along ``entry``'s axes, concatenated on the
    channels in block order."""
    t = t.movedim(-1, 0)
    for axis in reversed(axes_of(entry)):  # the minor axis first
        t = mc.all_gather(t, mesh, axis)
    return t.movedim(0, -1)


def mamba2_decode(p: Mamba2, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """One token: x (B,1,D) -> (y, state).  O(1) in context; the state's
    ``h`` and ``conv`` are written in place.

    Under an ambient mesh the state is laid out as
    ``backbone.decode_state_axes`` says: the conv window on ``ffn``, ``h``
    with every head on every rank.  Each rank steps its channels' conv
    window, the conv outputs are gathered (B·d_in values, where ``h`` is
    B·d_in·d_state), and every rank steps every head of ``h`` alike."""
    xz, bc, dt_raw = p.in_xz(x), p.in_bc(x), p.in_dt(x)
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        y = _local_mamba_decode(xz, bc, dt_raw, p.conv, p.a_log, p.d_skip, state["conv"],
                                state["h"], cfg=cfg, c0=0)
        return p.out(y), state
    from torch.distributed.tensor.experimental import local_map

    conv_spec = resolve_spec(("batch", None, "ffn"), state["conv"].shape, mesh)
    h_spec = resolve_spec(("batch", "state", None, None), state["h"].shape, mesh)
    own = {"conv": placements(conv_spec, mesh), "h": placements(h_spec, mesh)}
    if not all(is_dtensor(state[key]) and state[key].placements == pl
               for key, pl in own.items()):
        raise ValueError("the decode state is not laid out over the ambient mesh: make it "
                         "with backbone.init_decode_state(..., mesh=)")
    whole = placements((conv_spec[0], None, None), mesh)
    vec = placements((None,), mesh)
    d_in = cfg.d_model * cfg.ssm.expand
    entry = conv_spec[2]
    core = functools.partial(
        _local_mamba_decode, cfg=cfg, c0=block_start(mesh, entry, d_in),
        gather=functools.partial(_gather_channels, mesh=mesh, entry=entry) if entry else None)
    y = local_map(core, out_placements=list(own["conv"]), device_mesh=mesh,
                  in_placements=(whole, whole, whole, placements((None, entry), mesh), vec, vec,
                                 own["conv"], own["h"]),
                  redistribute_inputs=True)(xz, bc, dt_raw, unstrided(p.conv), p.a_log,
                                            p.d_skip, state["conv"], state["h"])
    return p.out(y), state
