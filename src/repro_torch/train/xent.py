"""Cross-entropy over huge vocabularies.

The PyTorch counterpart of ``repro.train.xent``:

* ``sharded_xent`` — plain stable log-softmax on materialized logits
  (smoke-scale and serving-path tests).
* ``vocab_parallel_xent`` — the fused lm-head + loss.  On one device it
  streams tiles of the lm-head weight against the tokens, keeping running
  (max, sum-exp, picked-logit) accumulators, so the full (N, V) logits never
  exist.  It is a ``torch.autograd.Function`` whose backward recomputes each
  tile from the saved inputs and the per-token log-sum-exp: the
  counterpart of the reference's ``jax.checkpoint(body)`` in its scan.  Tile
  products are plain ``torch.matmul`` in f32 on the inputs upcast, as the
  reference's ``preferred_element_type=f32`` einsum.  The reference's
  ``shard_map`` form (a mesh with a vocab axis) waits for the sharding port.
"""
from __future__ import annotations

import torch

NEG = -1e30
SHARDING_NOT_PORTED = ("vocab_parallel_xent over a mesh with a vocab axis is not ported "
                       "(sharding, ROADMAP queue 1 item 8)")


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
    """(N, tile) f32 logits of one weight tile, columns past ``real_vocab``
    at ``NEG``."""
    lt = torch.matmul(xf, wt.float().t()) * logit_scale
    gidx = v0 + torch.arange(wt.shape[0], device=xf.device)
    return torch.where(gidx[None, :] < real_vocab, lt, NEG)


class _TiledXent(torch.autograd.Function):
    """Mean NLL of ``x2 @ w.T * logit_scale`` over the valid labels, tile by
    tile; backward recomputes each tile."""

    @staticmethod
    def forward(ctx, x2, w, lab, real_vocab: int, tile: int, logit_scale: float):
        n = x2.shape[0]
        xf = x2.float()
        m = torch.full((n,), NEG, dtype=torch.float32, device=x2.device)
        se = torch.zeros((n,), dtype=torch.float32, device=x2.device)
        picked = torch.zeros((n,), dtype=torch.float32, device=x2.device)
        lab_col = lab.long()[:, None]
        for v0 in range(0, w.shape[0], tile):
            lt = _tile_logits(xf, w[v0:v0 + tile], v0, real_vocab, logit_scale)
            m_new = torch.maximum(m, lt.amax(dim=-1))
            se = se * torch.exp(m - m_new) + torch.sum(torch.exp(lt - m_new[:, None]), dim=-1)
            gidx = v0 + torch.arange(lt.shape[1], device=x2.device)
            picked = picked + torch.sum(torch.where(gidx[None, :] == lab_col, lt, 0.0), dim=-1)
            m = m_new
        lse = m + torch.log(se)
        valid = (lab >= 0).float()
        count = torch.clamp(torch.sum(valid), min=1.0)
        ctx.save_for_backward(x2, w, lab, lse, valid, count)
        ctx.cfg = (real_vocab, tile, logit_scale)
        return torch.sum((lse - picked) * valid) / count

    @staticmethod
    def backward(ctx, g):
        x2, w, lab, lse, valid, count = ctx.saved_tensors
        real_vocab, tile, logit_scale = ctx.cfg
        xf = x2.float()
        coef = (g * valid / count)[:, None]  # d loss / d nll per token
        lab_col = lab.long()[:, None]
        dx = torch.zeros_like(xf) if ctx.needs_input_grad[0] else None
        dw = torch.empty_like(w) if ctx.needs_input_grad[1] else None
        for v0 in range(0, w.shape[0], tile):
            wt = w[v0:v0 + tile]
            lt = _tile_logits(xf, wt, v0, real_vocab, logit_scale)
            gidx = v0 + torch.arange(lt.shape[1], device=x2.device)
            # softmax minus the one-hot label, times the token's weight
            dl = (torch.exp(lt - lse[:, None]) - (gidx[None, :] == lab_col).float()) * coef
            dl = dl * logit_scale
            if dx is not None:
                dx += torch.matmul(dl, wt.float())
            if dw is not None:
                dw[v0:v0 + tile] = torch.matmul(dl.t(), xf)
        return (dx.to(x2.dtype) if dx is not None else None, dw, None, None, None, None)


def vocab_parallel_xent(
    x: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    real_vocab: int,
    *,
    mesh=None,
    vocab_axis: str = "model",
    tile: int = 2048,
    logit_scale: float = 1.0,
) -> torch.Tensor:
    """Fused lm-head + cross-entropy.

    x (B, S, D) final hidden states; w (Vp, D) lm-head/tied embedding;
    labels (B, S) with -1 = ignore.  Returns mean nll (0-d f32).  ``mesh`` is
    a ``DeviceMesh``; one with a ``vocab_axis`` of more than one device
    raises (the sharded form is not ported).
    """
    if mesh is not None and mesh.size() > 1 and vocab_axis in (mesh.mesh_dim_names or ()):
        raise NotImplementedError(SHARDING_NOT_PORTED)
    d = x.shape[-1]
    return _TiledXent.apply(x.reshape(-1, d), w, labels.reshape(-1), real_vocab, tile,
                            logit_scale)
