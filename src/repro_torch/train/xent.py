"""Cross-entropy over huge vocabularies.

The PyTorch counterpart of ``repro.train.xent``:

* ``sharded_xent`` — plain stable log-softmax on materialized logits
  (smoke-scale and serving-path tests).
* ``vocab_parallel_xent`` — the fused lm-head + loss.  It streams tiles of
  the lm-head weight against the tokens, keeping running (max, sum-exp,
  picked-logit) accumulators, so the full (N, V) logits never exist.  Its
  backward recomputes each tile from the saved inputs and the per-token
  log-sum-exp: the counterpart of the reference's ``jax.checkpoint(body)`` in
  its scan.  Tile products are plain ``torch.matmul`` in f32 on the inputs
  upcast, as the reference's ``preferred_element_type=f32`` einsum.  Over a
  mesh with a vocab axis it is the reference's ``shard_map`` form in
  ``local_map``: each rank streams its own vocab shard of the weight against
  its own tokens, and the ranks combine their partial (max, sum-exp, picked)
  over the vocab axis; the lm-head gradient stays on its shard.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.dist import mesh_collectives as mc
from repro_torch.dist.sharding import (
    grad_placements,
    is_dtensor,
    mesh_sizes,
    placements,
    shard_tensor,
)

NEG = -1e30


def sharded_xent(logits: torch.Tensor, labels: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """logits (B, S, Vp) float, labels (B, S) int -> mean loss (0-d f32).

    Vp may exceed real_vocab (padding); padded columns are masked.  Label
    positions < 0 are ignored (padding tokens).
    """
    vp = logits.shape[-1]
    x = logits.float()
    vocab_ids = torch.arange(vp, device=x.device)
    x = torch.where(vocab_ids < real_vocab, x, NEG)
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))
    picked = torch.sum(torch.where(vocab_ids == labels[..., None].long(), x, 0.0), dim=-1)
    nll = lse - picked
    valid = (labels >= 0).float()
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _tile_logits(xf: torch.Tensor, wt: torch.Tensor, v0: int, real_vocab: int,
                 logit_scale: float) -> torch.Tensor:
    """(N, tile) f32 logits of one weight tile whose first row is vocab entry
    ``v0``, columns past ``real_vocab`` at ``NEG``."""
    lt = torch.matmul(xf, wt.float().t()) * logit_scale
    gidx = v0 + torch.arange(wt.shape[0], device=xf.device)
    return torch.where(gidx[None, :] < real_vocab, lt, NEG)


def _tile_stats(xf, w, lab, v0: int, real_vocab: int, tile: int, logit_scale: float):
    """The running (max, sum-exp, picked logit) per token over the rows of
    ``w``, vocab entries ``v0`` on."""
    n = xf.shape[0]
    m = torch.full((n,), NEG, dtype=torch.float32, device=xf.device)
    se = torch.zeros((n,), dtype=torch.float32, device=xf.device)
    picked = torch.zeros((n,), dtype=torch.float32, device=xf.device)
    lab_col = lab.long()[:, None]
    for t0 in range(0, w.shape[0], tile):
        lt = _tile_logits(xf, w[t0:t0 + tile], v0 + t0, real_vocab, logit_scale)
        m_new = torch.maximum(m, lt.amax(dim=-1))
        se = se * torch.exp(m - m_new) + torch.sum(torch.exp(lt - m_new[:, None]), dim=-1)
        gidx = v0 + t0 + torch.arange(lt.shape[1], device=xf.device)
        picked = picked + torch.sum(torch.where(gidx[None, :] == lab_col, lt, 0.0), dim=-1)
        m = m_new
    return m, se, picked


def _tile_grads(ctx, g, v0: int):
    """(dx, dw) of the mean NLL over the rows of ``w`` (vocab entries ``v0``
    on), each tile recomputed against the saved log-sum-exp: dx the f32 sum
    over the tiles, dw in w's dtype."""
    x2, w, lab, lse, valid, count = ctx.saved_tensors
    real_vocab, tile, logit_scale = ctx.cfg
    xf = x2.float()
    coef = (g * valid / count)[:, None]  # d loss / d nll per token
    lab_col = lab.long()[:, None]
    dx = torch.zeros_like(xf) if ctx.needs_input_grad[0] else None
    dw = torch.empty_like(w) if ctx.needs_input_grad[1] else None
    for t0 in range(0, w.shape[0], tile):
        wt = w[t0:t0 + tile]
        lt = _tile_logits(xf, wt, v0 + t0, real_vocab, logit_scale)
        gidx = v0 + t0 + torch.arange(lt.shape[1], device=xf.device)
        # softmax minus the one-hot label, times the token's weight
        dl = (torch.exp(lt - lse[:, None]) - (gidx[None, :] == lab_col).float()) * coef
        dl = dl * logit_scale
        if dx is not None:
            dx += torch.matmul(dl, wt.float())
        if dw is not None:
            dw[t0:t0 + tile] = torch.matmul(dl.t(), xf)
    return dx, dw


class _TiledXent(torch.autograd.Function):
    """Mean NLL of ``x2 @ w.T * logit_scale`` over the valid labels, tile by
    tile; backward recomputes each tile."""

    @staticmethod
    def forward(ctx, x2, w, lab, real_vocab: int, tile: int, logit_scale: float):
        m, se, picked = _tile_stats(x2.float(), w, lab, 0, real_vocab, tile, logit_scale)
        lse = m + torch.log(se)
        valid = (lab >= 0).float()
        count = torch.clamp(torch.sum(valid), min=1.0)
        ctx.save_for_backward(x2, w, lab, lse, valid, count)
        ctx.cfg = (real_vocab, tile, logit_scale)
        return torch.sum((lse - picked) * valid) / count

    @staticmethod
    def backward(ctx, g):
        dx, dw = _tile_grads(ctx, g, 0)
        return (dx.to(ctx.saved_tensors[0].dtype) if dx is not None else None, dw,
                None, None, None, None)


class _VocabShardXent(torch.autograd.Function):
    """One rank's part of the mean NLL over a mesh: ``x2`` its tokens, ``w``
    its vocab shard (entries ``v0`` on, ``v0 = shard * v_local``).  The
    ranks of ``vocab_axis`` combine their partial (max, sum-exp, picked), the
    max as a constant (``mesh_collectives.max_const``); the NLL and the valid
    count are summed over ``token_axes``.  Backward: each tile recomputed on
    the local shard against the global log-sum-exp; dw stays on the shard,
    dx is summed over ``vocab_axis``."""

    @staticmethod
    def forward(ctx, x2, w, lab, mesh, vocab_axis: str, token_axes: tuple, real_vocab: int,
                tile: int, logit_scale: float):
        v0 = mesh.get_local_rank(vocab_axis) * w.shape[0]
        x2 = x2.to(w.dtype)
        m, se, picked = _tile_stats(x2.float(), w, lab, v0, real_vocab, tile, logit_scale)
        m_all = mc.max_const(m, mesh, vocab_axis)
        se_all, picked_all = mc.all_reduce(torch.stack([se * torch.exp(m - m_all), picked]),
                                           mesh, (vocab_axis,))
        lse = m_all + torch.log(se_all)
        valid = (lab >= 0).float()
        sums = torch.stack([torch.sum((lse - picked_all) * valid), torch.sum(valid)])
        nll_sum, valid_sum = mc.all_reduce(sums, mesh, token_axes)
        count = torch.clamp(valid_sum, min=1.0)
        ctx.save_for_backward(x2, w, lab, lse, valid, count)
        ctx.cfg = (real_vocab, tile, logit_scale)
        ctx.mesh, ctx.vocab_axis, ctx.v0 = mesh, vocab_axis, v0
        return nll_sum / count

    @staticmethod
    def backward(ctx, g):
        dx, dw = _tile_grads(ctx, g, ctx.v0)
        if dx is not None:
            dx = mc.all_reduce(dx, ctx.mesh, (ctx.vocab_axis,)).to(ctx.saved_tensors[0].dtype)
        return dx, dw, None, None, None, None, None, None, None


def _xent_over_mesh(x, w, labels, real_vocab: int, mesh, token_axes: Sequence[str],
                    vocab_axis: str, tile: int, logit_scale: float) -> torch.Tensor:
    """The reference's ``shard_map`` form: tokens sharded over ``token_axes``
    (those of the mesh that divide the batch's rows, major first; the
    reference splits the flattened tokens, the same blocks where the rows
    divide) and replicated over ``vocab_axis``, the weight sharded over
    ``vocab_axis``."""
    from torch.distributed.tensor.experimental import local_map

    b, _, d = x.shape
    if w.shape[0] % mc.axis_size(mesh, vocab_axis):
        raise ValueError(f"a vocab of {w.shape[0]} does not split over {vocab_axis!r}")
    sizes = mesh_sizes(mesh)
    split, parts = [], 1
    for a in token_axes:
        if sizes.get(a, 1) > 1 and a != vocab_axis and b % (parts * sizes[a]) == 0:
            split.append(a)
            parts *= sizes[a]
    entry = (split[0] if len(split) == 1 else tuple(split)) if split else None
    if not is_dtensor(labels):  # every rank holds the whole batch
        labels = shard_tensor(labels, mesh, (None, None))
    x_pl, lab_pl = placements((entry, None, None), mesh), placements((entry, None), mesh)
    w_pl = placements((vocab_axis, None), mesh)

    def local(xl, labl, wl):
        return _VocabShardXent.apply(xl.reshape(-1, d), wl, labl.reshape(-1), mesh, vocab_axis,
                                     tuple(split), real_vocab, tile, logit_scale)

    loss = local_map(
        local, out_placements=list(placements((), mesh)), device_mesh=mesh,
        in_placements=(x_pl, lab_pl, w_pl), redistribute_inputs=True,
        in_grad_placements=(x_pl, lab_pl, grad_placements(w_pl, mesh, split)),
    )(x, labels, w)
    return loss.to_local()  # the same on every rank


def vocab_parallel_xent(
    x: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    real_vocab: int,
    *,
    mesh=None,
    token_axes: Sequence[str] = ("data",),
    vocab_axis: str = "model",
    tile: int = 2048,
    logit_scale: float = 1.0,
) -> torch.Tensor:
    """Fused lm-head + cross-entropy.

    x (B, S, D) final hidden states; w (Vp, D) lm-head/tied embedding;
    labels (B, S) with -1 = ignore.  Returns mean nll (0-d f32).  ``mesh`` is
    a ``DeviceMesh``; on one with a ``vocab_axis`` of more than one device,
    x and w are DTensors over it (labels a DTensor or a tensor every rank
    holds whole), each rank tiles its own vocab shard of w (``Vp`` must split
    evenly) and the returned loss is a plain tensor, the same on every rank.
    """
    if mesh is not None and mesh.size() > 1 and vocab_axis in (mesh.mesh_dim_names or ()):
        return _xent_over_mesh(x, w, labels, real_vocab, mesh, token_axes, vocab_axis, tile,
                               logit_scale)
    d = x.shape[-1]
    return _TiledXent.apply(x.reshape(-1, d), w, labels.reshape(-1), real_vocab, tile,
                            logit_scale)
