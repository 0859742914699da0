"""GQA attention with RoPE: full-sequence (flash or chunked), and decode.

The PyTorch counterpart of ``repro.models.attention``.

* Full-sequence attention (prefill) on a CUDA device takes the hand-written
  flash kernel (``repro_torch.kernels.flash_attention``) at any length: the
  kernel masks its own ragged edge, so the JAX package's gate (S and Sk
  multiples of 256, a Pallas block constraint) is not copied.  On the CPU,
  or with ``use_flash=False``, it runs ``_chunked_attention``, the streaming
  softmax over KV chunks in plain PyTorch.  The kernel is a forward only,
  so training takes the chunked path (``use_flash=False``), as the
  reference's differentiable path does.
* Cross-attention (the whisper decoder) takes its keys and values from
  ``cross_kv`` over the encoder's output; on a CUDA device it too runs the
  flash kernel (bidirectional, Sq != Sk), where the reference always takes
  its chunked path.
* Decode consumes a KV cache laid out (batch, kv_len, kv_heads, head_dim).
  The cache is updated in place (slice assignment at ``position``), where
  JAX builds a new one with ``dynamic_update_slice``; over a mesh each rank
  writes its own shard of it.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from dataclasses import dataclass
from typing import Iterator

import torch
from torch import nn

from repro_torch.dist.sharding import ambient_mesh, is_dtensor, placements, resolve_spec
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG_INF, streaming_attention

from .common import Dense, HeadLayout, apply_rope, block_start, rope_angles, spec
from .config import ArchConfig


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _chunked_attention(q, k, v, *, causal: bool, chunk: int):
    """Streaming-softmax grouped attention (GQA without repeating K/V).

    q: (B, Sq, kvH, G, D); k/v: (B, Sk, kvH, D).  Walks Sk in equal chunks
    (``ref.streaming_attention``); q is scaled in its own dtype, and P is
    cast to v's dtype before the PV product, as in the reference.  The
    products run in f32 on q/k/v upcast from their dtype: the reference's
    ``preferred_element_type=f32`` products on the same values.  Under
    autograd each chunk is checkpointed, as the reference's
    ``jax.checkpoint(body)``: backward recomputes a chunk's scores.
    """
    d = q.shape[-1]
    sk = k.shape[1]
    n_chunks = max(1, sk // chunk)
    if sk % n_chunks:  # the reference's reshape into equal chunks fails too
        raise ValueError(f"key length {sk} does not split into {n_chunks} equal chunks")
    q = q * (1.0 / math.sqrt(d))
    out = streaming_attention(q, k, v, causal=causal, block=sk // n_chunks, p_dtype=v.dtype)
    return out.to(q.dtype)  # (B, Sq, kvH, G, D)


class Attention(nn.Module):
    """Projections ``wq``, ``wk``, ``wv``, ``wo`` (bias when ``qkv_bias``)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device) -> None:
        super().__init__()
        d, hd, bias = cfg.d_model, cfg.head_dim, cfg.qkv_bias
        kw = dict(bias=bias, dtype=dtype, device=device)
        self.wq = Dense(d, cfg.n_heads * hd, axes=spec("embed", "heads"), **kw)
        self.wk = Dense(d, cfg.n_kv_heads * hd, axes=spec("embed", "kv"), **kw)
        self.wv = Dense(d, cfg.n_kv_heads * hd, axes=spec("embed", "kv"), **kw)
        self.wo = Dense(cfg.n_heads * hd, d, axes=spec("heads", "embed"), **kw)


_FLASH_INPUTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "flash_inputs", default=None)


@contextlib.contextmanager
def record_flash_inputs() -> Iterator[dict]:
    """Within the context, copies of the first flash call's q, k, v and its
    ``causal`` go into the dict it yields: under a mesh, the local shards
    the kernel was handed on this rank."""
    rec: dict = {}
    token = _FLASH_INPUTS.set(rec)
    try:
        yield rec
    finally:
        _FLASH_INPUTS.reset(token)


def _attend(q, k, v, *, causal: bool, chunk: int, use_flash: bool | None) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, kvH, hd) after RoPE -> (B, Sq, H, hd):
    the flash kernel (``use_flash=None``: where q lies on a CUDA device) or
    the chunked plain path."""
    b, s, h, hd = q.shape
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    if use_flash:
        rec = _FLASH_INPUTS.get()
        if rec is not None and not rec:
            rec.update(q=q.clone(), k=k.clone(), v=v.clone(), causal=causal)
        return flash_attention(q, k, v, causal=causal)
    qg = q.reshape(b, s, k.shape[2], h // k.shape[2], hd)
    out = _chunked_attention(qg, k, v, causal=causal, chunk=min(chunk, k.shape[1]))
    return out.reshape(b, s, h, hd)


def attention(
    p: Attention,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    causal: bool = True,
    chunk: int = 512,
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill).  ``use_flash=None`` takes the
    flash kernel where x lies on a CUDA device; ``False`` takes the chunked
    plain path.

    With ``cross_kv`` (k, v of ``cross_kv()``, (B, Sk, kvH, hd)) it is
    cross-attention: only q is projected from x, neither q nor k gets RoPE,
    and the mask is bidirectional, as in the reference.

    A DTensor x under an ambient mesh takes ``_attention_sharded``; there
    ``cross_kv`` holds the unsplit projections ``cross_kv()`` gives of a
    DTensor."""
    mesh = ambient_mesh()
    if mesh is not None and is_dtensor(x):
        return _attention_sharded(p, cfg, x, mesh, causal=causal, chunk=chunk,
                                  use_flash=use_flash, cross_kv=cross_kv)
    if cross_kv is None:
        return p.wo(_local_attention(p.wq(x), p.wk(x), p.wv(x), cfg=cfg, h0=0, causal=causal,
                                     chunk=chunk, use_flash=use_flash))
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = _split_heads(p.wq(x), cfg.n_heads, hd)
    k, v = cross_kv
    out = _attend(q, k, v, causal=False, chunk=chunk, use_flash=use_flash)
    return p.wo(out.reshape(b, s, cfg.n_heads * hd))


def _kv_read(cfg: ArchConfig, h0: int, hl: int, kv0: int, k, v):
    """The keys and values that query heads h0..h0+hl read, from k/v (B, L,
    kv, hd) holding kv heads kv0 on: query head h reads kv head ``h // (H //
    kvH)``.  The heads read, as a slice, where the query heads group evenly
    over them; else one kv head per query head."""
    kv_of = torch.arange(h0, h0 + hl) // (cfg.n_heads // cfg.n_kv_heads) - kv0
    lo, hi = int(kv_of[0]), int(kv_of[-1]) + 1
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if hl % (hi - lo) or not torch.equal(kv_of - lo, torch.arange(hl) // (hl // (hi - lo))):
        k, v = k[:, :, kv_of - lo], v[:, :, kv_of - lo]
    return k, v


def _local_attention(q2, k2, v2, *, cfg: ArchConfig, h0: int, causal: bool, chunk: int,
                     use_flash: bool | None, rope: bool = True) -> torch.Tensor:
    """One rank's attention: q2 (B, S, Hl*hd) its query heads h0..h0+Hl,
    k2/v2 (B, Sk, kvH*hd) every kv head, each over the whole sequence (Sk
    = S, or the encoder's length for cross-attention, ``rope=False``).

    Query head h reads kv head ``h // (H // kvH)``: the rank keeps the kv
    heads its query heads read, and where its heads do not split evenly over
    them, one kv head per query head."""
    b, s, _ = q2.shape
    hd = cfg.head_dim
    hl = q2.shape[-1] // hd
    k, v = _kv_read(cfg, h0, hl, 0, _split_heads(k2, cfg.n_kv_heads, hd),
                    _split_heads(v2, cfg.n_kv_heads, hd))
    q = _split_heads(q2, hl, hd)
    if rope:
        positions = torch.arange(s, device=q2.device)[None, :]
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = _attend(q, k, v, causal=causal, chunk=chunk, use_flash=use_flash)
    return out.reshape(b, s, hl * hd)


def _attention_sharded(p: Attention, cfg: ArchConfig, x, mesh, *, causal: bool, chunk: int,
                       use_flash: bool | None, cross_kv=None):
    """Attention of a DTensor x over ``mesh``.

    The projections are DTensor products of the sharded weights.  The
    attention itself runs per rank inside ``local_map`` (the reference's
    GSPMD partition of its chunked scan): q laid out as the reference's
    constraint ``(batch, seq, heads, None)`` resolves on the head count, with
    the sequence kept whole (the kernel and the chunked path take whole
    sequences), k and v with every head on every rank (``HeadLayout``).  So
    the flash kernel runs on each rank's local heads, and its plain version
    on the same shards.  Cross-attention runs the same core on the encoder's
    k and v, bidirectional and without RoPE."""
    from torch.distributed.tensor.experimental import local_map

    b, s, _ = x.shape
    lay = HeadLayout(mesh, b, s, cfg.n_heads, cfg.head_dim)
    # k and v: each rank's query heads read only their own kv heads, so the
    # gradient sums over the axis that splits the heads
    core = local_map(
        functools.partial(_local_attention, cfg=cfg, h0=lay.h0,
                          causal=causal and cross_kv is None, chunk=chunk, use_flash=use_flash,
                          rope=cross_kv is None),
        out_placements=list(lay.heads), in_placements=(lay.heads, lay.whole, lay.whole),
        in_grad_placements=(lay.heads, lay.whole_grad, lay.whole_grad), device_mesh=mesh,
        redistribute_inputs=True)
    k2, v2 = (p.wk(x), p.wv(x)) if cross_kv is None else cross_kv
    return p.wo(core(p.wq(x), k2, v2))


def cross_kv(p: Attention, cfg: ArchConfig, enc: torch.Tensor):
    """Encoder K/V for cross-attention (the whisper decoder): (B, Sk, kvH, hd)
    each, without RoPE.  Of a DTensor ``enc`` (over a mesh) the projections
    (B, Sk, kvH*hd) unsplit: each rank splits the heads it reads inside
    attention's ``local_map``, as DTensor cannot unflatten a dimension
    sharded at other than a head's boundary."""
    if is_dtensor(enc):
        return p.wk(enc), p.wv(enc)
    hd = cfg.head_dim
    k = _split_heads(p.wk(enc), cfg.n_kv_heads, hd)
    v = _split_heads(p.wv(enc), cfg.n_kv_heads, hd)
    return k, v


# ------------------------------------------------------------------ decoding
@dataclass
class KVCacheSpec:
    batch: int
    kv_len: int
    n_kv_heads: int
    head_dim: int
    dtype: torch.dtype

    def zeros(self, layers: int, device) -> dict[str, torch.Tensor]:
        """``k``/``v`` of shape (layers, batch, kv_len, kvH, hd): one buffer
        per layer, since decode writes each in place."""
        shape = (layers, self.batch, self.kv_len, self.n_kv_heads, self.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}


def decode_attention(
    p: Attention,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: dict[str, torch.Tensor],
    position: int,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode: x (B, 1, D), cache k/v (B, L, kvH, hd).

    The new key and value are written into ``cache`` in place at
    ``position``; the same dict is returned.  A DTensor x under an ambient
    mesh takes ``_decode_attention_sharded``.
    """
    mesh = ambient_mesh()
    if mesh is not None and is_dtensor(x):
        return _decode_attention_sharded(p, cfg, x, cache, position, mesh), cache
    out = _local_decode(p.wq(x), p.wk(x), p.wv(x), cache["k"], cache["v"], cfg=cfg, h0=0, kv0=0,
                        position=position)
    return p.wo(out), cache


def _local_decode(q2, k2, v2, ck, cv, *, cfg: ArchConfig, h0: int, kv0: int,
                  position: int) -> torch.Tensor:
    """One rank's decode attention: q2 (B, 1, Hl*hd) its query heads
    h0..h0+Hl, k2/v2 (B, 1, kvl*hd) the new key and value of the kv heads its
    cache ck/cv (B, L, kvl, hd) holds, kv0 on.  The new key and value are
    written into the cache in place at ``position``."""
    b = q2.shape[0]
    hd = cfg.head_dim
    hl, kvl = q2.shape[-1] // hd, k2.shape[-1] // hd
    pos = torch.full((b, 1), position, dtype=torch.int32, device=q2.device)
    cos, sin = rope_angles(pos, hd, cfg.rope_theta)
    q = apply_rope(_split_heads(q2, hl, hd), cos, sin)  # (B,1,Hl,hd)
    k_new = apply_rope(_split_heads(k2, kvl, hd), cos, sin)
    # past the end of the cache the write lands on its last slot, as the
    # reference's clamped ``dynamic_update_slice`` does
    slot = min(position, ck.shape[1] - 1)
    ck[:, slot:slot + 1] = k_new
    cv[:, slot:slot + 1] = _split_heads(v2, kvl, hd)
    k, v = _kv_read(cfg, h0, hl, kv0, ck, cv)
    qg = q.reshape(b, 1, k.shape[2], hl // k.shape[2], hd) / math.sqrt(hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    mask = torch.arange(k.shape[1], device=q2.device) <= position
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, 1, hl * hd)


def _decode_attention_sharded(p: Attention, cfg: ArchConfig, x, cache: dict, position: int,
                              mesh):
    """Decode attention of a DTensor x over ``mesh``, the cache laid out by
    ``backbone.init_decode_state(..., mesh=)``.  The projections are DTensor
    products; the rest runs per rank in ``local_map`` on its local query
    heads and its local shard of the cache, into which the new key and value
    are written in place (the inputs are handed over in the cache's own
    placements, so nothing is copied)."""
    from torch.distributed.tensor.experimental import local_map

    b = x.shape[0]
    hd = cfg.head_dim
    c_spec = resolve_spec(("batch", "kv_seq", "kv", None), tuple(cache["k"].shape), mesh)
    c_pl = placements(c_spec, mesh)
    if not all(is_dtensor(t) and t.placements == c_pl for t in cache.values()):
        raise ValueError("the decode state is not laid out over the ambient mesh: make it "
                         "with backbone.init_decode_state(..., mesh=)")
    lay = HeadLayout(mesh, b, 1, cfg.n_heads, hd)
    kv_pl = placements((c_spec[0], None, c_spec[2]), mesh)
    kv0 = block_start(mesh, c_spec[2], cfg.n_kv_heads)
    core = local_map(
        functools.partial(_local_decode, cfg=cfg, h0=lay.h0, kv0=kv0, position=position),
        out_placements=list(lay.heads), in_placements=(lay.heads, kv_pl, kv_pl, c_pl, c_pl),
        device_mesh=mesh, redistribute_inputs=True)
    return p.wo(core(p.wq(x), p.wk(x), p.wv(x), cache["k"], cache["v"]))
