"""Model: init / forward / decode of the dense family.

The PyTorch counterpart of ``repro.models.backbone`` for ``family ==
"dense"``: a homogeneous decoder stack (``Backbone`` -> ``ModuleList`` of
``DecoderBlock`` -> ``Attention`` / ``MLP`` / ``Norm`` / ``Dense``), GQA
attention with RoPE, SwiGLU or GeLU FFN, optional parallel block.  Parameter
names follow the JAX tree with the stacked layer axis split
(``blocks.{i}.attn.wq.w``), so ``models.weights.params_from_jax`` is a name
map.  The MoE, SSM, hybrid, VLM and audio families are not ported yet and
raise.

The decode state is ``{"kv": {"k", "v"}}`` with a leading layer axis, as in
the reference; ``decode_step`` updates it in place.
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
from .common import DTYPES, Embedding, Norm, constrain
from .config import ArchConfig
from .mlp import MLP, MOE_NOT_PORTED, mlp

NOT_PORTED = ("only the dense family is ported (ROADMAP: MoE, SSM, hybrid, VLM "
              "and audio); got family {!r}")


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype, device) -> None:
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = attn.Attention(cfg, dtype=dtype, device=device)
        self.ln2 = None if cfg.parallel_block else Norm(cfg.d_model, cfg.norm, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype=dtype, device=device)


def decoder_block(p: DecoderBlock, cfg: ArchConfig, x, *, chunk=512, use_flash=None):
    """Full-sequence block.  Returns (out, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = p.ln1(x)
    a = attn.attention(p.attn, cfg, h, chunk=chunk, use_flash=use_flash)
    if cfg.parallel_block:
        f = mlp(p.mlp, h, cfg.mlp_act)
        out = x + (a + f) * cfg.residual_scale
    else:
        x = x + a * cfg.residual_scale
        h2 = p.ln2(x)
        f = mlp(p.mlp, h2, cfg.mlp_act)
        out = x + f * cfg.residual_scale
    out = constrain(out, "batch", "seq", "embed")
    return out, aux


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
    and recomputes the rest in backward, ``dots`` keeps the dense products."""
    if cfg.remat == "none":
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
    """The dense model; parameters are allocated uninitialised (see
    ``init_model`` and ``weights.params_from_jax``)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda") -> None:
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(NOT_PORTED.format(cfg.family))
        if cfg.moe:
            raise NotImplementedError(MOE_NOT_PORTED)
        dtype = DTYPES[cfg.param_dtype]
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dtype=dtype, device=device)
        self.ln_f = Norm(cfg.d_model, cfg.norm, device=device)
        self.lm_head = None if cfg.tie_embeddings else Embedding(
            cfg.padded_vocab, cfg.d_model, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, dtype=dtype, device=device) for _ in range(cfg.n_layers))


def init_model(cfg: ArchConfig, *, generator: torch.Generator, device="cuda") -> Backbone:
    """A model with random weights, drawn from ``generator`` with the
    reference's distributions: dense ``U(-1/sqrt(d_in), 1/sqrt(d_in))`` with
    zero bias, embeddings ``N(0, 0.02^2)``, norms at scale 1 and bias 0.
    ``generator`` must live on ``device``."""
    model = Backbone(cfg, device=device)
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
    return model


# ==================================================================== forward
def lm_head_weight(p: Backbone, cfg: ArchConfig) -> torch.Tensor:
    return p.embed.w if cfg.tie_embeddings else p.lm_head.w


def _logits(p: Backbone, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(x, lm_head_weight(p, cfg).t()) * cfg.logit_scale
    return constrain(logits, "batch", "seq", "vocab")


def _embed_inputs(p: Backbone, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    x = p.embed(batch["tokens"]) * cfg.embed_scale
    return constrain(x, "batch", "seq", "embed")


def forward_hidden(p: Backbone, cfg: ArchConfig, batch: dict, *, chunk: int = 512,
                   use_flash: bool | None = None):
    """Backbone forward up to the final norm (pre-logits).  Returns (x, aux).

    Under autograd each block runs under ``cfg.remat`` (``_remat``); with
    grad off (serving) the blocks run as they are."""
    x = _embed_inputs(p, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(decoder_block, cfg) if torch.is_grad_enabled() else decoder_block
    for bp in p.blocks:
        x, a = block(bp, cfg, x, chunk=chunk, use_flash=use_flash)
        aux = aux + a
    return p.ln_f(x), aux


def forward(p: Backbone, cfg: ArchConfig, batch: dict, *, chunk: int = 512,
            use_flash: bool | None = None):
    """Full-sequence forward (prefill).  ``batch["tokens"]`` (B, S) on the
    model's device.  Returns (logits (B, S, padded_vocab), aux).
    ``use_flash=None`` takes the flash kernel on a CUDA device."""
    x, aux = forward_hidden(p, cfg, batch, chunk=chunk, use_flash=use_flash)
    return _logits(p, cfg, x), aux


# ===================================================================== decode
def init_decode_state(cfg: ArchConfig, batch: int, kv_len: int, *, device="cuda") -> dict:
    """Zero KV caches ``{"kv": {"k", "v"}}``, each (L, B, kv_len, kvH, hd)."""
    if cfg.family != "dense":
        raise NotImplementedError(NOT_PORTED.format(cfg.family))
    spec = attn.KVCacheSpec(batch, kv_len, cfg.n_kv_heads, cfg.head_dim,
                            DTYPES[cfg.param_dtype])
    return {"kv": spec.zeros(cfg.n_layers, device)}


def decode_step(p: Backbone, cfg: ArchConfig, state: dict, tokens: torch.Tensor,
                position: int):
    """One-token decode.  tokens (B, 1); returns (logits (B, 1, V), state).

    The caches in ``state`` are written in place at ``position``.
    """
    x = p.embed(tokens) * cfg.embed_scale
    kv = state["kv"]
    for i, bp in enumerate(p.blocks):
        cache = {"k": kv["k"][i], "v": kv["v"][i]}
        hn = bp.ln1(x)
        a, _ = attn.decode_attention(bp.attn, cfg, hn, cache, position)
        if cfg.parallel_block:
            x = x + (a + mlp(bp.mlp, hn, cfg.mlp_act)) * cfg.residual_scale
        else:
            x = x + a * cfg.residual_scale
            x = x + mlp(bp.mlp, bp.ln2(x), cfg.mlp_act) * cfg.residual_scale
    x = p.ln_f(x)
    return _logits(p, cfg, x), state
