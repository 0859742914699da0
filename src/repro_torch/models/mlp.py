"""Feed-forward blocks: SwiGLU / GeLU and the token-choice MoE layer.

The PyTorch counterpart of ``repro.models.mlp``.  The MoE layer:
sort-based top-k dispatch into (experts, capacity) slots, the experts' FFN
as batched products, and a scatter-add combine; over a mesh, the reference's
``_moe_spmd`` in ``local_map`` with ``all_to_all`` (expert parallel) or summed
FFN shards (tensor parallel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.dist import mesh_collectives as mc
from repro_torch.dist.sharding import (
    ambient_mesh,
    axes_of,
    current_rules,
    grad_placements,
    is_dtensor,
    mesh_sizes,
    placements,
    resolve_spec,
)

from .common import Dense, _param, constrain, spec
from .config import ArchConfig, MoEConfig


class MLP(nn.Module):
    """Weights of ``mlp``: ``up``, ``down``, and ``gate`` for SwiGLU."""

    def __init__(self, d: int, d_ff: int, act: str, *, dtype, device) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.up = Dense(d, d_ff, axes=spec("embed", "ffn"), **kw)
        self.gate = Dense(d, d_ff, axes=spec("embed", "ffn"), **kw) if act == "swiglu" else None
        self.down = Dense(d_ff, d, axes=spec("ffn", "embed"), **kw)


def _act(h: torch.Tensor, gate: torch.Tensor | None) -> torch.Tensor:
    """SwiGLU (``silu(gate) * h``) where there is a gate, else GeLU in
    ``jax.nn.gelu``'s default (tanh) form."""
    if gate is not None:
        return F.silu(gate) * h
    return F.gelu(h, approximate="tanh")


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    h = _act(p.up(x), p.gate(x) if act == "swiglu" else None)
    h = constrain(h, "batch", "seq", "ffn")
    return p.down(h)


# ------------------------------------------------------------------------ MoE
class MoE(nn.Module):
    """Weights of the MoE layer: ``router.w`` f32 ``(d, E)``, ``up`` and
    ``gate`` ``(E, d, f)``, ``down`` ``(E, f, d)``.  ``gate`` exists for GeLU
    experts too (unused there), as the reference's ``init_moe`` makes it."""

    def __init__(self, d: int, moe: MoEConfig, *, dtype, device) -> None:
        super().__init__()
        e, f = moe.num_experts, moe.d_ff_expert
        self.router = Dense(d, e, axes=spec("embed", None), dtype=torch.float32, device=device)
        self.up = _param((e, d, f), dtype, device)
        self.gate = _param((e, d, f), dtype, device)
        self.down = _param((e, f, d), dtype, device)
        self.axes = {"up": spec("expert", "embed", "ffn"), "gate": spec("expert", "embed", "ffn"),
                     "down": spec("expert", "ffn", "embed")}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Expert weights ``U(-1/sqrt(d), 1/sqrt(d))``, ``down`` included
        (the reference draws all three with the model width's limit); the
        router is a ``Dense`` and draws its own."""
        lim = 1.0 / math.sqrt(self.up.shape[1])
        for w in (self.up, self.gate, self.down):
            w.uniform_(-lim, lim, generator=generator)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps equal values in index
    order; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(moe: MoEConfig, n: int, k: int) -> int:
    """Slots per expert for ``n`` tokens routed ``k`` ways, in Python float
    arithmetic as the reference computes it."""
    return max(8, min(int(moe.capacity_factor * n * k / moe.num_experts), n))


def _dispatch_local(tokens: torch.Tensor, router_w: torch.Tensor, moe: MoEConfig, k: int):
    """Local sort-based top-k dispatch: returns (xs (E, C, D), combine info
    ``(slot, t_sorted, g_sorted, keep, capacity, aux)``).

    Each (token, choice) pair is sorted by expert (stably, so an expert's
    slots go to its tokens in token order); the pairs past an expert's
    ``capacity`` are dropped into the overflow slot ``E * C``, which is
    scattered into and then cut off."""
    n, d = tokens.shape
    e = moe.num_experts
    logits = tokens.float() @ router_w  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # (N, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    density = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)
    density_prob = probs.mean(dim=0)
    aux = e * torch.sum(density * density_prob)

    cap = capacity(moe, n, k)
    flat_expert = expert_idx.reshape(n * k)
    flat_gate = gate_vals.reshape(n * k)
    flat_tok = torch.arange(n, device=tokens.device).repeat_interleave(k)

    order = torch.argsort(flat_expert, stable=True)
    e_sorted = flat_expert[order]
    t_sorted = flat_tok[order]
    g_sorted = flat_gate[order]
    same = torch.arange(n * k, device=tokens.device)
    start = torch.searchsorted(e_sorted, torch.arange(e, device=tokens.device), side="left")
    pos = same - start[e_sorted]
    keep = pos < cap
    slot = torch.where(keep, e_sorted * cap + pos, e * cap)

    xs = torch.zeros((e * cap + 1, d), dtype=tokens.dtype, device=tokens.device)
    xs.index_add_(0, slot, tokens[t_sorted] * keep[:, None].to(tokens.dtype))
    xs = xs[:-1].reshape(e, cap, d)
    return xs, (slot, t_sorted, g_sorted, keep, cap, aux)


def _combine_local(ys: torch.Tensor, info, n: int) -> torch.Tensor:
    """Each token's ``k`` expert outputs, weighted by its gates, scatter-added
    in expert order (the sort's); dropped pairs read the zero overflow row."""
    slot, t_sorted, g_sorted, keep, cap, _ = info
    e, _, d = ys.shape
    flat_ys = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))], dim=0)
    contrib = flat_ys[slot] * (g_sorted * keep).to(ys.dtype)[:, None]
    return ys.new_zeros((n, d)).index_add_(0, t_sorted, contrib)


class _BmmF32(torch.autograd.Function):
    """``aten::bmm.dtype`` with a gradient: PyTorch defines none for it.

    Forward: the tensor cores' product of the low-precision inputs, summed
    in f32.  Backward: each input's gradient as the reference's transpose of
    ``einsum(..., preferred_element_type=f32)`` computes it, the f32
    cotangent times the other input upcast, in f32, cast to the input's
    dtype; one batch entry (expert) at a time, so an upcast operand is never
    larger than one expert's weights."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        ga = torch.empty_like(a) if ctx.needs_input_grad[0] else None
        gb = torch.empty_like(b) if ctx.needs_input_grad[1] else None
        for e in range(g.shape[0]):
            if ga is not None:
                ga[e] = g[e] @ b[e].float().T
            if gb is not None:
                gb[e] = a[e].float().T @ g[e]
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(..., preferred_element_type=f32)``: a batched product with an
    f32 result.  On a CUDA device bf16 inputs stay bf16 and the tensor cores
    accumulate into f32 (``_BmmF32``, which gives the product its gradient);
    the CPU build has no such kernel, so there the inputs are upcast, which
    is the same arithmetic."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _expert_ffn(xs, up, gate, down, act: str) -> torch.Tensor:
    """(E, C, D) -> (E, C, D): each expert's FFN on its slots, the up and
    gate products in f32, the down product in the activations' dtype."""
    h = _bmm_f32(xs, up)
    h = _act(h, _bmm_f32(xs, gate) if act == "swiglu" else None)
    return torch.bmm(h.to(xs.dtype), down)


def moe_layer_with_loss(p: MoE, cfg: ArchConfig, x: torch.Tensor, *, mesh=None):
    """Token-choice top-k MoE: returns (out (B, S, D), aux).

    Without a mesh (``mesh``, or else the ambient one), or on a mesh of one
    device or without a ``model`` dimension: the local sort-based dispatch.
    On a mesh: ``_moe_spmd``, each rank routing its own tokens.  Under
    ``obs.tracing`` it counts the (token, choice) pairs routed and those
    dropped over capacity (``moe.pairs.{routed,dropped}``, per rank on a
    mesh); reading the count waits for the device, so it is read only when
    tracing."""
    mesh = ambient_mesh() if mesh is None else mesh
    if mesh is None or mesh.size() == 1 or "model" not in (mesh.mesh_dim_names or ()):
        return _moe_single(p, cfg, x)
    return _moe_spmd(p, cfg, x, mesh)


def _count_pairs(info) -> None:
    if obs.enabled():
        keep = info[3]
        obs.counter_add("moe.pairs.routed", keep.numel())
        obs.counter_add("moe.pairs.dropped",
                        int(keep.numel() - keep.sum()))  # check: ignore[host-read] tracing only


def _moe_single(p: MoE, cfg: ArchConfig, x: torch.Tensor):
    moe = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    xs, info = _dispatch_local(tokens, p.router.w, moe, moe.top_k)
    _count_pairs(info)
    ys = _expert_ffn(xs, p.up, p.gate, p.down, cfg.mlp_act)
    out = _combine_local(ys, info, tokens.shape[0])
    return out.reshape(b, s, d), info[-1]


def _moe_spmd(p: MoE, cfg: ArchConfig, x, mesh):
    """The reference's ``_moe_spmd``: the whole layer runs per rank in
    ``local_map`` (its ``shard_map``); each rank routes and packs its own
    tokens, then either

    * EP (E % model == 0 and ``sharding == "expert"``, e.g. dbrx's 16
      experts over 4): an ``all_to_all`` over ``model`` ships each expert's
      slots to its owner, the local experts' FFN runs, and the reverse
      ``all_to_all`` brings the outputs back;
    * TP (otherwise, e.g. grok's ``sharding="ffn"``): every rank holds
      every expert's ``ffn`` shard, and the partial outputs are summed.

    The hidden dim may also shard over data (tp2d: ``extra_ffn``), whose
    partial outputs are summed too.  Partial sums combine only for the same
    tokens: over a partial axis that also shards the tokens (``tp_sp``), the
    tokens are gathered first and the summed outputs reduce-scattered back.
    With tokens replicated over ``model`` (EP), the outputs are averaged over
    it, and ``aux`` is averaged over every axis along which it may differ.
    Capacity counts each rank's own tokens, so the drops differ from the
    single-device layer's.

    Gradients flow through the collectives' transposes
    (``dist.mesh_collectives``) and back out of ``local_map`` with the
    placements of ``sharding.grad_placements``: a replicated input's
    gradient is summed over the axes along which the ranks' work differs."""
    from torch.distributed.tensor.experimental import local_map

    if not all(is_dtensor(t) for t in (x, p.router.w, p.up, p.gate, p.down)):
        raise TypeError("the MoE over a mesh takes DTensors: shard the model over the mesh "
                        "(models.weights.shard_model) and its input")
    moe = cfg.moe
    b, s, d = x.shape
    sizes = mesh_sizes(mesh)
    ep = moe.num_experts % sizes["model"] == 0 and moe.sharding == "expert"
    rules = current_rules()
    x_spec = resolve_spec(("batch", "seq", None), x.shape, mesh, rules)
    f = moe.d_ff_expert
    extra_ffn = tuple(a for a in rules.mesh_axes("ffn")
                      if a != "model" and a in sizes and f % sizes[a] == 0)
    ffn_entry = extra_ffn if ep else ("model",) + extra_ffn
    ffn_entry = (ffn_entry[0] if len(ffn_entry) == 1 else ffn_entry) if ffn_entry else None
    expert_entry = "model" if ep else None
    w_up_spec = (expert_entry, None, ffn_entry)
    w_down_spec = (expert_entry, ffn_entry, None)
    token_axes = tuple(a for e in x_spec for a in axes_of(e))
    partial_axes = extra_ffn if ep else ("model",) + extra_ffn
    gather_axes = tuple(a for a in partial_axes if a in token_axes)
    psum_axes = tuple(a for a in partial_axes if a not in token_axes)
    # the axes along which ranks compute with other tokens or weight shards:
    # their cotangents of a replicated input add up to its gradient; along
    # any other axis every rank computes alike (aux included, whose mean is
    # then taken over these axes alone: the same value)
    varying = tuple(a for a in mesh.mesh_dim_names
                    if a in token_axes or a in partial_axes or (ep and a == "model"))

    def local(xl, router, up, gate, down):
        bl, sl, _ = xl.shape
        tokens = xl.reshape(bl * sl, d)
        for a in gather_axes:
            tokens = mc.all_gather(tokens, mesh, a)
        xs, info = _dispatch_local(tokens, router, moe, moe.top_k)
        _count_pairs(info)
        if ep:
            xs = mc.all_to_all(xs, mesh, "model", split_dim=0, concat_dim=1)
            ys = _expert_ffn(xs, up, gate, down, cfg.mlp_act)
            ys = mc.all_to_all(ys, mesh, "model", split_dim=1, concat_dim=0)
        else:
            ys = _expert_ffn(xs, up, gate, down, cfg.mlp_act)
        out = _combine_local(ys, info, tokens.shape[0])
        if psum_axes:
            out = mc.all_reduce(out, mesh, psum_axes)
        for a in reversed(gather_axes):
            out = mc.reduce_scatter(out, mesh, a)
        if ep and "model" not in token_axes:
            out = mc.mean(out, mesh, ("model",))
        aux = mc.mean(info[-1], mesh, varying)
        return out.reshape(bl, sl, d), aux

    x_pl = placements(x_spec, mesh)
    up_pl, down_pl = placements(w_up_spec, mesh), placements(w_down_spec, mesh)
    replicated = placements((None,), mesh)
    in_pl = (x_pl, placements((None, None), mesh), up_pl, up_pl, down_pl)
    return local_map(
        local, out_placements=(x_pl, replicated), device_mesh=mesh, redistribute_inputs=True,
        in_placements=in_pl,
        in_grad_placements=tuple(grad_placements(pl, mesh, varying) for pl in in_pl),
    )(x, p.router.w, p.up, p.gate if cfg.mlp_act == "swiglu" else p.up, p.down)


def moe_layer(p: MoE, cfg: ArchConfig, x: torch.Tensor, *, mesh=None) -> torch.Tensor:
    return moe_layer_with_loss(p, cfg, x, mesh=mesh)[0]
