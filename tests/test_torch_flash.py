"""Port parity: flash attention and the chunked attention path.

On a CPU tensor the port's ``flash_attention`` runs its plain version,
``flash_attention_ref``, which must match the JAX Pallas kernel run in
interpret mode over the reference's sweep (``tests/test_flash_attention.py``
``SWEEP``): atol 3e-5 at f32 and 3e-2 at bf16, the reference's own
tolerances.  The port's ``_chunked_attention`` must match the JAX one at f32.
The wrapper's input checks and the bf16 kernel's TMA/wgmma geometry
(``hopper_geometry``, which ``chip_smoke.py`` holds equal to the built
kernel's) are checked on the CPU too; the kernel itself is held against the
plain version on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.attention as attn_mod

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import _chunked_attention as jax_chunked

from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    SMEM_LIMIT,
    flash_attention,
    flash_attention_ref,
    hopper_geometry,
    rows_aligned,
)
from repro_torch.models.attention import Attention, _chunked_attention, attention

SWEEP = [
    # b, sq, sk, h, kvh, d, causal, bq, bk
    (1, 256, 256, 2, 2, 64, True, 128, 128),
    (2, 512, 512, 1, 1, 128, True, 256, 128),
    (1, 256, 512, 2, 2, 64, False, 128, 256),
    (1, 256, 256, 4, 2, 64, True, 128, 128),  # GQA groups=2
    (2, 256, 256, 8, 2, 32, True, 128, 64),  # GQA groups=4
    (1, 128, 384, 3, 1, 64, False, 128, 128),  # MQA, rectangular
]
IDS = ["%d-%d-%d-%d-%d-%d-%s" % s[:7] for s in SWEEP]


def _qkv(rng, b, sq, sk, h, kvh, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,bq,bk", SWEEP, ids=IDS)
def test_flash_matches_jax_kernel_f32(b, sq, sk, h, kvh, d, causal, bq, bk):
    q, k, v = _qkv(np.random.default_rng(b * 100 + sq + h), b, sq, sk, h, kvh, d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     block_q=bq, block_k=bk, interpret=True)
    before = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal)
    assert flash_attention.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,bq,bk", SWEEP, ids=IDS)
def test_flash_matches_jax_kernel_bf16(b, sq, sk, h, kvh, d, causal, bq, bk):
    q, k, v = _qkv(np.random.default_rng(b * 100 + sq + h + 1), b, sq, sk, h, kvh, d)
    want = jax_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), causal=causal, block_q=bq, block_k=bk,
                     interpret=True)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,kvh,g,d,chunk", [
    (256, 256, 2, 2, 64, 128), (32, 32, 2, 3, 16, 8), (48, 48, 1, 4, 32, 48),
])
def test_chunked_attention_matches_jax_f32(sq, sk, kvh, g, d, chunk, causal):
    rng = np.random.default_rng(sq + g)
    q = rng.standard_normal((2, sq, kvh, g, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, kvh, d)).astype(np.float32)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       chunk=chunk)
    got = _chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_flash_ref_matches_chunked_path():
    """The flash plain version and the chunked path agree (as the reference's
    ``test_flash_matches_training_path``)."""
    rng = np.random.default_rng(9)
    b, s, kvh, g, d = 1, 256, 2, 2, 64
    q = torch.from_numpy(rng.standard_normal((b, s, kvh, g, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kvh, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kvh, d)).astype(np.float32))
    want = _chunked_attention(q, k, v, causal=True, chunk=128)
    got = flash_attention_ref(q.reshape(b, s, kvh * g, d), k, v, causal=True)
    np.testing.assert_allclose(got.reshape(b, s, kvh, g, d).numpy(), want.numpy(), atol=3e-5)


def test_flash_ref_ragged_lengths_match_dense_softmax():
    """The plain version has no block-multiple restriction (the kernel masks
    its own ragged edge): hold it to a dense softmax at odd lengths."""
    rng = np.random.default_rng(5)
    # Sk 300 and 530 end in a partial kv block of the plain version's 256
    for sq, sk, causal in ((77, 77, True), (40, 530, False), (300, 300, True)):
        q = torch.from_numpy(rng.standard_normal((2, sq, 6, 32)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((2, sk, 3, 32)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((2, sk, 3, 32)).astype(np.float32))
        kr, vr = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(32)
        if causal:
            s = s.masked_fill(~torch.ones(sq, sk, dtype=torch.bool).tril(), -1e30)
        want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
        got = flash_attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "rank", "heads", "head_dim_mismatch",
                                 "device"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32)
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "rank":
        q = q[0]
    elif bad == "heads":
        k, v = torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32)
    elif bad == "head_dim_mismatch":
        k, v = torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16)
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)


def test_chunked_attention_refuses_unequal_chunks():
    """Sk 1537 with chunk 512 splits into 3 chunks of unequal length: the
    reference's reshape fails, and so does the port."""
    q, k = torch.zeros(1, 4, 1, 1, 8), torch.zeros(1, 1537, 1, 8)
    with pytest.raises(ValueError, match="equal chunks"):
        _chunked_attention(q, k, k, causal=False, chunk=512)


@pytest.mark.parametrize("s", [77, 256, 300])
def test_attention_flash_dispatch_at_any_length(monkeypatch, s):
    """``use_flash=True`` hands every length to the flash wrapper (the kernel
    masks its ragged edge; on the CPU the wrapper runs its plain version),
    and matches the chunked path at f32.  ``use_flash=None`` on the CPU
    takes the chunked path."""
    cfg = get_smoke("starcoder2-3b")
    g = torch.Generator().manual_seed(s)
    p = Attention(cfg, dtype=torch.float32, device="cpu")
    for dense in (p.wq, p.wk, p.wv, p.wo):
        dense.reset_parameters(g)
    x = torch.randn((2, s, cfg.d_model), generator=g)
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return flash_attention(*a, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", spy)
    got = attention(p, cfg, x, use_flash=True)
    assert calls == [(2, s, cfg.n_heads, cfg.head_dim)]
    want = attention(p, cfg, x, use_flash=False)
    attention(p, cfg, x)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_hopper_geometry_fits_tma_and_wgmma(d):
    """The boxes tile D exactly; a box row is at most the 128 B a swizzled TMA
    box may span, and is exactly the swizzle the wgmma descriptors assume;
    every buffer starts on the 1024-byte swizzle period; shared memory and
    the setmaxnreg split fit one SM."""
    geo = hopper_geometry(d)
    assert geo["box_cols"] * geo["boxes"] == d
    assert geo["box_cols"] * 2 == geo["swizzle_bytes"] <= 128
    assert geo["swizzle_bytes"] in (64, 128) and geo["swizzle_bytes"] % 16 == 0
    assert geo["tile_m"] == 2 * 64 and geo["tile_n"] % 16 == 0 and geo["tile_n"] <= 256
    for rows in (64, geo["tile_m"], geo["tile_n"]):  # Q/O boxes, Q and K/V tiles
        assert rows * geo["swizzle_bytes"] % 1024 == 0 and rows <= 256
    assert geo["smem_bytes"] <= SMEM_LIMIT
    assert geo["threads"] == 3 * 128
    assert 128 * geo["producer_regs"] + 256 * geo["consumer_regs"] <= 65536
    assert geo["producer_regs"] % 8 == 0 and geo["consumer_regs"] % 8 == 0


def test_rows_aligned_accepts_fused_views_and_refuses_odd_strides():
    """The tensor maps read q/k/v through their byte strides, which must be
    multiples of 16: views of a fused (B, S, H + 2 kvH, D) tensor pass, a
    head dim cut out of a wider row does not."""
    for d in HEAD_DIMS:
        fused = torch.zeros(2, 9, 6 + 2 * 2, d, dtype=torch.bfloat16)
        assert all(rows_aligned(t) for t in (fused[:, :, :6], fused[:, :, 6:8], fused[:, :, 8:]))
    assert not rows_aligned(torch.zeros(1, 9, 2, 36, dtype=torch.bfloat16)[..., :32])
    with pytest.raises(ValueError):
        hopper_geometry(48)
