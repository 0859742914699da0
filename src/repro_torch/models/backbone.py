"""Model: init / forward / decode for all ten architectures.

The PyTorch counterpart of ``repro.models.backbone``.  Families:

* dense | moe | vlm: a homogeneous decoder stack (``Backbone.blocks``, a
  ``ModuleList`` of ``DecoderBlock``), GQA attention with RoPE, a SwiGLU or
  GeLU FFN or the token-choice MoE.  The VLM prepends the caller's patch
  embeddings (``batch["vis_embeds"]``) to the token stream.
* ssm (xlstm): ``blocks`` of ``XLSTMLayer``, mLSTM with every
  ``slstm_every``-th an sLSTM.
* hybrid (zamba2): Mamba2 layers ``mamba_main`` (whole segments) and
  ``mamba_rem`` (the remainder), with one weight-tied ``shared`` decoder
  block run after each segment.
* audio (whisper): an ``encoder`` stack over the caller's frame embeddings
  (``batch["frames"]``), ``ln_enc``, then decoder ``blocks`` with
  cross-attention (``lnx``/``xattn``) onto the encoder's output.

Parameter names follow the JAX tree with every stacked layer axis split
(``blocks.{i}.attn.wq.w``, ``mamba_main.{i}.core.in_xz.w``,
``encoder.{i}.mlp.up.w``), so ``models.weights.params_from_jax`` is a name
map.  The decode state has the reference's layout: ``{"kv": {"k", "v"}}``
with a leading layer axis (plus ``"enc"`` for audio), ``{"blocks": [...]}``
for ssm, and ``{"mamba": {"h", "conv"}, "shared_kv": {"k", "v"}}`` for
hybrid, leading axes over layers and over shared-block calls.
``decode_step`` writes the KV caches and the Mamba2 states in place.

Every family runs laid out over a ``(data, model)`` mesh (``use_mesh``): the
model by ``weights.shard_model``, the decode state by
``init_decode_state(..., mesh=)``, each activation a DTensor.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from . import attention as attn
from . import mamba2 as m2
from . import xlstm as xl
from repro_torch.dist.sharding import (
    ambient_mesh,
    gather_inner,
    is_dtensor,
    mesh_sizes,
    placements,
    resolve_spec,
    shard_tensor,
    unstrided,
)

from .common import DTYPES, Embedding, Norm, constrain, spec
from .config import ArchConfig
from .mlp import MLP, MoE, mlp, moe_layer_with_loss


def _xlstm_is_slstm(cfg: ArchConfig, i: int) -> bool:
    return bool(cfg.slstm_every) and (i + 1) % cfg.slstm_every == 0


def _segments(cfg: ArchConfig) -> tuple[int, int, int]:
    """hybrid: (layers per segment, whole segments, remaining layers)."""
    seg = cfg.shared_attn_every or cfg.n_layers
    segs, rem = divmod(cfg.n_layers, seg)
    return seg, segs, rem


# ===================================================================== blocks
class DecoderBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype, device, cross: bool = False) -> None:
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = attn.Attention(cfg, dtype=dtype, device=device)
        if cross:
            self.lnx = Norm(cfg.d_model, cfg.norm, device=device)
            self.xattn = attn.Attention(cfg, dtype=dtype, device=device)
        self.ln2 = None if cfg.parallel_block else Norm(cfg.d_model, cfg.norm, device=device)
        if cfg.moe:
            self.moe = MoE(cfg.d_model, cfg.moe, dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype=dtype, device=device)


def _ffn(p: DecoderBlock, cfg: ArchConfig, h: torch.Tensor):
    """The block's FFN on h: (out, aux), aux the MoE's balance loss or 0."""
    if cfg.moe:
        return moe_layer_with_loss(p.moe, cfg, h)
    return mlp(p.mlp, h, cfg.mlp_act), torch.zeros((), dtype=torch.float32, device=h.device)


def decoder_block(p: DecoderBlock, cfg: ArchConfig, x, *, enc_kv=None, chunk=512,
                  use_flash=None):
    """Full-sequence block.  Returns (out, aux_loss)."""
    h = p.ln1(x)
    a = attn.attention(p.attn, cfg, h, chunk=chunk, use_flash=use_flash)
    if cfg.parallel_block:
        f, aux = _ffn(p, cfg, h)
        out = x + (a + f) * cfg.residual_scale
    else:
        x = x + a * cfg.residual_scale
        if enc_kv is not None:
            hx = p.lnx(x)
            x = x + attn.attention(p.xattn, cfg, hx, cross_kv=enc_kv, chunk=chunk,
                                   use_flash=use_flash) * cfg.residual_scale
        f, aux = _ffn(p, cfg, p.ln2(x))
        out = x + f * cfg.residual_scale
    out = constrain(out, "batch", "seq", "embed")
    return out, aux


class XLSTMLayer(nn.Module):
    """One ssm block: ``ln``, ``core`` (mLSTM or sLSTM), and ``ln2``/``mlp``
    where the config has a ``d_ff``."""

    def __init__(self, cfg: ArchConfig, i: int, *, dtype, device) -> None:
        super().__init__()
        self.ln = Norm(cfg.d_model, cfg.norm, device=device)
        core = xl.SLSTM if _xlstm_is_slstm(cfg, i) else xl.MLSTM
        self.core = core(cfg, dtype=dtype, device=device)
        if cfg.d_ff:
            self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype=dtype, device=device)


def xlstm_layer(p: XLSTMLayer, cfg: ArchConfig, i: int, x: torch.Tensor) -> torch.Tensor:
    h = p.ln(x)
    core = xl.slstm_block if _xlstm_is_slstm(cfg, i) else xl.mlstm_block
    out = x + core(p.core, cfg, h)
    if cfg.d_ff:
        out = out + mlp(p.mlp, p.ln2(out), cfg.mlp_act)
    return constrain(out, "batch", "seq", "embed")


class MambaLayer(nn.Module):
    """One hybrid Mamba2 layer: ``ln`` and ``core``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device) -> None:
        super().__init__()
        self.ln = Norm(cfg.d_model, cfg.norm, device=device)
        self.core = m2.Mamba2(cfg, dtype=dtype, device=device)


def mamba_layer(p: MambaLayer, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = x + m2.mamba2_block(p.core, cfg, p.ln(x))
    return constrain(x, "batch", "seq", "embed")


# "dots": the products with no batch dims (the dense layers' ``x @ w``, which
# dispatch to ``mm``) are kept, all else is recomputed, as the reference's
# ``checkpoint_dots_with_no_batch_dims``; attention's batched products
# (``bmm``) are recomputed
_KEPT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_products(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _KEPT_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` under the config's rematerialisation policy (the reference's
    ``_remat``): ``none`` runs it as it is, ``full`` keeps only its inputs
    and recomputes the rest in backward, ``dots`` keeps the dense products.
    With grad off (serving) every block runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _keep_products)
    elif cfg.remat == "full":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"unknown remat policy {cfg.remat!r}")

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)

    return run


class Backbone(nn.Module):
    """The model of any family; parameters are allocated uninitialised (see
    ``init_model`` and ``weights.params_from_jax``)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda") -> None:
        super().__init__()
        self.cfg = cfg
        dtype = DTYPES[cfg.param_dtype]
        kw = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.ln_f = Norm(cfg.d_model, cfg.norm, device=device)
        self.lm_head = None if cfg.tie_embeddings else Embedding(
            cfg.padded_vocab, cfg.d_model, **kw)
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            self.blocks = nn.ModuleList(DecoderBlock(cfg, **kw) for _ in range(cfg.n_layers))
        elif fam == "ssm":
            self.blocks = nn.ModuleList(XLSTMLayer(cfg, i, **kw) for i in range(cfg.n_layers))
        elif fam == "hybrid":
            seg, segs, rem = _segments(cfg)
            self.mamba_main = nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(segs * seg))
            if rem:
                self.mamba_rem = nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(rem))
            self.shared = DecoderBlock(cfg, **kw)  # weight-tied across calls
        elif fam == "audio":
            self.encoder = nn.ModuleList(DecoderBlock(cfg, **kw)
                                         for _ in range(cfg.encoder_layers))
            self.ln_enc = Norm(cfg.d_model, cfg.norm, device=device)
            self.blocks = nn.ModuleList(DecoderBlock(cfg, cross=True, **kw)
                                        for _ in range(cfg.n_layers))
        else:
            raise ValueError(f"unknown family {fam}")


def init_model(cfg: ArchConfig, *, generator: torch.Generator, device="cuda") -> Backbone:
    """A model with random weights, drawn from ``generator`` with the
    reference's distributions: dense ``U(-1/sqrt(d_in), 1/sqrt(d_in))`` with
    zero bias (f32 for the MoE router and the mLSTM gates), MoE experts
    ``U(-1/sqrt(d), 1/sqrt(d))``, embeddings and the Mamba2 conv ``N(0,
    0.02^2)``, Mamba2 ``a_log`` 0 and ``d_skip`` 1, norms at scale 1 and bias
    0.  ``generator`` must live on ``device``."""
    model = Backbone(cfg, device=device)
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
    return model


# ==================================================================== forward
def _mesh_of_many():
    """The ambient mesh if one of its dimensions has more than one device."""
    mesh = ambient_mesh()
    return mesh if mesh is not None and any(n > 1 for n in mesh_sizes(mesh).values()) else None


def _check_mesh(p: Backbone) -> None:
    """Under a mesh of more than one device only a sharded model runs: never
    a silently replicated one."""
    if _mesh_of_many() is None:
        return
    if not is_dtensor(p.embed.w):
        raise ValueError("the model is not laid out over the ambient mesh: "
                         "call models.weights.shard_model(model, mesh) first")


def lm_head_weight(p: Backbone, cfg: ArchConfig) -> torch.Tensor:
    return unstrided(p.embed.w if cfg.tie_embeddings else p.lm_head.w)


def _logits(p: Backbone, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if is_dtensor(x):
        x = gather_inner(x)
    logits = torch.matmul(x, lm_head_weight(p, cfg).t()) * cfg.logit_scale
    return constrain(logits, "batch", "seq", "vocab")


def _embed_inputs(p: Backbone, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    tokens = batch["tokens"]
    mesh = ambient_mesh()
    if mesh is not None:
        # the lookup takes the ids whole on every rank: DTensor's masked
        # vocab-parallel lookup of sharded ids reduces its partial sums with a
        # mask cut for the ids' shard after it has gathered the output
        whole = (None,) * tokens.dim()
        tokens = (tokens.redistribute(mesh, placements(whole, mesh)) if is_dtensor(tokens)
                  else shard_tensor(tokens, mesh, whole))  # every rank holds the whole batch
    x = p.embed(tokens) * cfg.embed_scale
    if cfg.family == "vlm" and "vis_embeds" in batch:
        vis = batch["vis_embeds"].to(x.dtype)
        if mesh is not None:  # both laid out alike, the sequence whole, for the cat
            spec_ = resolve_spec(("batch", None, "embed"), x.shape, mesh)
            x = x.redistribute(mesh, placements(spec_, mesh))
            vis = (vis.redistribute(mesh, x.placements) if is_dtensor(vis)
                   else shard_tensor(vis, mesh, spec_))
        x = torch.cat([vis, x], dim=1)
    return constrain(x, "batch", "seq", "embed")


def _encoder_block(bp: DecoderBlock, cfg: ArchConfig, x, *, use_flash=None):
    a = attn.attention(bp.attn, cfg, bp.ln1(x), causal=False, use_flash=use_flash)
    x = x + a
    return x + mlp(bp.mlp, bp.ln2(x), cfg.mlp_act)


def _run_encoder(p: Backbone, cfg: ArchConfig, frames: torch.Tensor, *,
                 use_flash: bool | None = None) -> torch.Tensor:
    """Whisper encoder over the frame embeddings (B, frames, d) (the conv
    frontend is a stub in the reference too): bidirectional self-attention
    with RoPE, KV chunks of 512.  Under an ambient mesh, frames that every
    rank holds whole are laid out ``("batch", None, "embed")`` first."""
    x = frames.to(DTYPES[cfg.param_dtype])
    mesh = ambient_mesh()
    if mesh is not None and not is_dtensor(x):
        x = shard_tensor(x, mesh, resolve_spec(("batch", None, "embed"), x.shape, mesh))
    block = _remat(_encoder_block, cfg)
    for bp in p.encoder:
        x = block(bp, cfg, x, use_flash=use_flash)
    return p.ln_enc(x)


def forward_hidden(p: Backbone, cfg: ArchConfig, batch: dict, *, chunk: int = 512,
                   use_flash: bool | None = None):
    """Backbone forward up to the final norm (pre-logits).  Returns (x, aux).

    Under autograd each block runs under ``cfg.remat`` (``_remat``); with
    grad off (serving) the blocks run as they are.

    Under an ambient mesh (``dist.sharding.use_mesh``) every family runs
    sharded: the model must have been laid out over it
    (``weights.shard_model``); the tokens, patches and frames enter
    replicated, as the reference's unsharded inputs (or as DTensors), every
    activation is a DTensor laid out by the ``constrain`` points and
    DTensor's propagation, the per-rank cores (attention, mLSTM, sLSTM,
    Mamba2) run in ``local_map``, and the returned x is one."""
    _check_mesh(p)
    x = _embed_inputs(p, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        block = _remat(decoder_block, cfg)
        for bp in p.blocks:
            x, a = block(bp, cfg, x, chunk=chunk, use_flash=use_flash)
            aux = aux + (a.to_local() if is_dtensor(a) else a)  # replicated on every rank
    elif fam == "ssm":
        layer = _remat(xlstm_layer, cfg)
        for i, bp in enumerate(p.blocks):
            x = layer(bp, cfg, i, x)
    elif fam == "hybrid":
        seg, segs, _ = _segments(cfg)
        layer = _remat(mamba_layer, cfg)
        shared = _remat(decoder_block, cfg)
        for gi in range(segs):
            for bp in p.mamba_main[gi * seg:(gi + 1) * seg]:
                x = layer(bp, cfg, x)
            x, a = shared(p.shared, cfg, x, chunk=chunk, use_flash=use_flash)
            aux = aux + (a.to_local() if is_dtensor(a) else a)
        for bp in getattr(p, "mamba_rem", ()):
            x = layer(bp, cfg, x)
    elif fam == "audio":
        enc = _run_encoder(p, cfg, batch["frames"], use_flash=use_flash)

        def block(bp, h):
            kv = attn.cross_kv(bp.xattn, cfg, enc)
            return decoder_block(bp, cfg, h, enc_kv=kv, chunk=chunk, use_flash=use_flash)

        block = _remat(block, cfg)
        for bp in p.blocks:
            x, a = block(bp, x)
            aux = aux + (a.to_local() if is_dtensor(a) else a)
    else:
        raise ValueError(fam)
    return p.ln_f(x), aux


def forward(p: Backbone, cfg: ArchConfig, batch: dict, *, chunk: int = 512,
            use_flash: bool | None = None):
    """Full-sequence forward (prefill).  ``batch["tokens"]`` (B, S) on the
    model's device, with ``vis_embeds`` (vlm) or ``frames`` (audio) where the
    family takes them.  Returns (logits (B, S', padded_vocab), aux), S' = S
    plus the visual prefix.  ``use_flash=None`` takes the flash kernel on a
    CUDA device."""
    x, aux = forward_hidden(p, cfg, batch, chunk=chunk, use_flash=use_flash)
    return _logits(p, cfg, x), aux


# ===================================================================== decode
def decode_state_axes(cfg: ArchConfig, batch: int, kv_len: int) -> dict:
    """The logical axes of ``init_decode_state(cfg, batch, kv_len)``'s state,
    leaf for leaf: the reference's ``init_decode_state`` axes, which do not
    depend on the sizes.  KV caches ``(None, "batch", "kv_seq", "kv", None)``
    (the leading layer or shared-block-call axis replicated), the audio
    encoder's output ``("batch", None, "embed")``, the xLSTM states per
    block and the Mamba2 states with their leading layer axis."""
    kv = spec(None, "batch", "kv_seq", "kv", None)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "audio"):
        axes = {"kv": {"k": kv, "v": kv}}
        if fam == "audio":
            axes["enc"] = spec("batch", None, "embed")
        return axes
    if fam == "ssm":
        slstm = {"h": spec("batch", "embed"), "c": spec("batch", "embed"),
                 "n": spec("batch", "embed")}
        return {"blocks": [dict(slstm) if _xlstm_is_slstm(cfg, i)
                           else {"c": spec("batch", "heads", None, None)}
                           for i in range(cfg.n_layers)]}
    if fam == "hybrid":
        return {"mamba": {"h": spec(None, "batch", "state", None, None),
                          "conv": spec(None, "batch", None, "ffn")},
                "shared_kv": {"k": kv, "v": kv}}
    raise ValueError(fam)


def init_decode_state(cfg: ArchConfig, batch: int, kv_len: int, *, device="cuda",
                      mesh=None) -> dict:
    """The family's zero decode state (see the module docstring): KV caches
    (L, B, kv_len, kvH, hd), the audio encoder's output ``enc`` (B,
    encoder_seq, d) for the caller to set, xLSTM states per block, Mamba2
    states stacked over layers and the shared block's caches over its calls.

    With ``mesh`` each leaf is a DTensor over it, laid out as
    ``decode_state_axes`` resolve under the ambient rules."""
    state = _zero_decode_state(cfg, batch, kv_len, device)
    if mesh is None:
        return state

    def lay_out(leaf, axes):
        if isinstance(leaf, dict):
            return {key: lay_out(sub, axes[key]) for key, sub in leaf.items()}
        if isinstance(leaf, list):
            return [lay_out(sub, ax) for sub, ax in zip(leaf, axes)]
        return shard_tensor(leaf, mesh, resolve_spec(axes, leaf.shape, mesh))

    return lay_out(state, decode_state_axes(cfg, batch, kv_len))


def _zero_decode_state(cfg: ArchConfig, batch: int, kv_len: int, device) -> dict:
    dtype = DTYPES[cfg.param_dtype]
    fam = cfg.family
    caches = attn.KVCacheSpec(batch, kv_len, cfg.n_kv_heads, cfg.head_dim, dtype)
    if fam in ("dense", "moe", "vlm", "audio"):
        state = {"kv": caches.zeros(cfg.n_layers, device)}
        if fam == "audio":
            state["enc"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                                       device=device)
        return state
    if fam == "ssm":
        return {"blocks": [
            xl.slstm_init_state(cfg, batch, dtype, device=device) if _xlstm_is_slstm(cfg, i)
            else xl.mlstm_init_state(cfg, batch, device=device)
            for i in range(cfg.n_layers)]}
    if fam == "hybrid":
        _, segs, _ = _segments(cfg)
        return {"mamba": m2.mamba2_init_state(cfg, batch, layers=cfg.n_layers, device=device),
                "shared_kv": caches.zeros(segs, device)}
    raise ValueError(fam)


def _layer(tree: dict, i: int) -> dict:
    return {key: leaf[i] for key, leaf in tree.items()}


def _decode_decoder_block(bp: DecoderBlock, cfg: ArchConfig, x, cache: dict, position: int):
    hn = bp.ln1(x)
    a, _ = attn.decode_attention(bp.attn, cfg, hn, cache, position)
    if cfg.parallel_block:
        return x + (a + _ffn(bp, cfg, hn)[0]) * cfg.residual_scale
    x = x + a * cfg.residual_scale
    return x + _ffn(bp, cfg, bp.ln2(x))[0] * cfg.residual_scale


def decode_step(p: Backbone, cfg: ArchConfig, state: dict, tokens: torch.Tensor,
                position: int):
    """One-token decode.  tokens (B, 1); returns (logits (B, 1, V), state).

    The KV caches and Mamba2 states in ``state`` are written in place at
    ``position``; the xLSTM states are replaced.

    Under an ambient mesh every family runs sharded, as the forward does
    (the model laid out by ``weights.shard_model``, the state by
    ``init_decode_state(..., mesh=)``): each rank writes its own shard of
    the caches and Mamba2 states, the xLSTM states come back laid out as
    they went in, and the logits are a DTensor.  The audio state's ``enc``
    is set by the caller (``ServeEngine.encode``)."""
    _check_mesh(p)
    x = _embed_inputs(p, cfg, {"tokens": tokens})
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        for i, bp in enumerate(p.blocks):
            x = _decode_decoder_block(bp, cfg, x, _layer(state["kv"], i), position)
    elif fam == "audio":
        enc = state["enc"]
        for i, bp in enumerate(p.blocks):
            a, _ = attn.decode_attention(bp.attn, cfg, bp.ln1(x), _layer(state["kv"], i),
                                         position)
            x = x + a
            kv = attn.cross_kv(bp.xattn, cfg, enc)  # recomputed each step, as the reference
            x = x + attn.attention(bp.xattn, cfg, bp.lnx(x), cross_kv=kv)
            x = x + mlp(bp.mlp, bp.ln2(x), cfg.mlp_act)
    elif fam == "ssm":
        new_states = []
        for i, (bp, st) in enumerate(zip(p.blocks, state["blocks"])):
            step = xl.slstm_decode if _xlstm_is_slstm(cfg, i) else xl.mlstm_decode
            y, st = step(bp.core, cfg, bp.ln(x), st)
            x = x + y
            if cfg.d_ff:
                x = x + mlp(bp.mlp, bp.ln2(x), cfg.mlp_act)
            new_states.append(st)
        state = {"blocks": new_states}
    elif fam == "hybrid":
        seg, segs, _ = _segments(cfg)
        mstate = state["mamba"]
        layers = list(p.mamba_main) + list(getattr(p, "mamba_rem", ()))
        for i, bp in enumerate(layers):
            x = x + m2.mamba2_decode(bp.core, cfg, bp.ln(x), _layer(mstate, i))[0]
            if i % seg == seg - 1 and i // seg < segs:  # the end of a segment
                sh = p.shared
                cache = _layer(state["shared_kv"], i // seg)
                a, _ = attn.decode_attention(sh.attn, cfg, sh.ln1(x), cache, position)
                x = x + a
                x = x + mlp(sh.mlp, sh.ln2(x), cfg.mlp_act)
    else:
        raise ValueError(fam)
    x = p.ln_f(x)
    return _logits(p, cfg, x), state
