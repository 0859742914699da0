"""Port parity: the training path.

The same numpy inputs go through the JAX package and the port: schedules,
AdamW, the fused cross-entropy, the synthetic stream, the loss and its full
gradient tree, and whole train steps.  At f32 only the order of sums
differs.  Tolerances: learning rates rtol 1e-6 (each library's own f32
``cos``/``exp``); AdamW outputs rtol 1e-6 in f32 and one bf16 rounding step
(2^-7 relative) for bf16 moments; the cross-entropy's value rtol 1e-5 and
its gradients atol 1e-5; the model's loss rtol 1e-5 and gradients atol 1e-6
with rtol 1e-5 (xlstm's atol 5e-6, ``GRAD_ATOL``); one train step's parameters atol 2e-5, the tolerance of
``tests/test_train.py::test_microbatched_step_matches_full_batch``, and its
AdamW moments at the gradients' tolerance carried through (m atol 1e-7,
v atol 1e-8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro import train as rtrain
from repro.models import backbone as rbb
from repro.train import optimizer as ropt
from repro.train import xent as rxent

from repro_torch import configs as tconfigs
from repro_torch import train as ttrain
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models.weights import named_arrays, opt_state_from_jax, params_from_jax
from repro_torch.train import optimizer as topt
from repro_torch.train import xent as txent
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GRAD_ARCHS = ["starcoder2_3b", "minicpm_2b", "command_r_35b", "dbrx_132b", "grok_1_314b",
              "xlstm_125m", "zamba2_1p2b", "internvl2_1b", "whisper_small"]
# xlstm's f32 gradient is ill-conditioned: the reference's own lies more than
# 1e-6 from an f64 evaluation (tests/test_torch_family_train.py shows it)
GRAD_ATOL = {"xlstm_125m": 5e-6}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _pair(arch, dtype="float32", seed=0, **overrides):
    cfg_r = dataclasses.replace(rconfigs.get_smoke(arch), param_dtype=dtype, **overrides)
    cfg_t = dataclasses.replace(tconfigs.get_smoke(arch), param_dtype=dtype, **overrides)
    params, _ = rbb.init_model(jax.random.key(seed), cfg_r)
    model = params_from_jax(cfg_t, jax.tree.map(np.asarray, params), device="cpu")
    return cfg_r, cfg_t, params, model.requires_grad_(True)


def _torch_batch(batch):
    """The reference's batch as tensors; bf16 side inputs (``vis_embeds``,
    ``frames``) go through f32, which holds every bf16 value exactly."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = _t(a.astype(np.float32)).to(torch.bfloat16) if a.dtype.name == "bfloat16" else _t(a)
    return out


# ------------------------------------------------------------------ schedule
SCHEDULES = [
    dict(peak_lr=1e-3, warmup_steps=100, total_steps=10_000),
    dict(peak_lr=3e-4, warmup_steps=2, total_steps=7, decay_frac=0.3, min_lr_frac=0.05),
    dict(peak_lr=1.0, warmup_steps=10, total_steps=100, decay_frac=0.2, min_lr_frac=0.1),
    dict(warmup_steps=0, total_steps=1),
]


@pytest.mark.parametrize("kind", ["cosine", "wsd", "constant"])
@pytest.mark.parametrize("sched", range(len(SCHEDULES)))
def test_learning_rate_matches_reference(kind, sched):
    kw = SCHEDULES[sched]
    steps = list(range(0, 130)) + list(range(8800, 10_010, 3))
    want = np.array([np.float32(rtrain.learning_rate(s, rtrain.ScheduleConfig(kind=kind, **kw)))
                     for s in steps])
    got = np.array([ttrain.learning_rate(s, ttrain.ScheduleConfig(kind=kind, **kw)).item()
                    for s in steps], dtype=np.float32)
    assert ttrain.learning_rate(3, ttrain.ScheduleConfig(kind=kind, **kw)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_learning_rate_rejects_unknown_kind():
    with pytest.raises(ValueError):
        ttrain.learning_rate(1, ttrain.ScheduleConfig(kind="linear"))


# ----------------------------------------------------------------- optimizer
def _opt_inputs(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.01).astype(np.float32) for k, s in shapes.items()}
    v = {k: (rng.random(s) * 1e-4).astype(np.float32) for k, s in shapes.items()}
    return params, grads, m, v


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 100.0], ids=["no_clip", "clip"])
def test_adamw_update_matches_reference(state_dtype, grad_scale):
    params, grads, m, v = _opt_inputs(3, grad_scale)
    cfg_r = ropt.AdamWConfig(state_dtype=state_dtype)
    cfg_t = topt.AdamWConfig(state_dtype=state_dtype)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[state_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    state_r = {"m": {k: jnp.asarray(x, jdt) for k, x in m.items()},
               "v": {k: jnp.asarray(x, jdt) for k, x in v.items()},
               "count": jnp.asarray(2, jnp.int32)}
    lr = 3e-3
    p_r, s_r, gn_r = ropt.adamw_update({k: jnp.asarray(x) for k, x in params.items()},
                                       {k: jnp.asarray(x) for k, x in grads.items()},
                                       state_r, lr, cfg_r)
    p_t = {k: _t(x) for k, x in params.items()}
    state_t = {"m": {k: _t(x).to(tdt) for k, x in m.items()},
               "v": {k: _t(x).to(tdt) for k, x in v.items()},
               "count": torch.tensor(2, dtype=torch.int32)}
    out_p, s_t, gn_t = topt.adamw_update(p_t, {k: _t(x) for k, x in grads.items()}, state_t,
                                         torch.tensor(lr, dtype=torch.float32), cfg_t)
    assert out_p is p_t and s_t is state_t  # in place
    clip = float(gn_r) > cfg_r.grad_clip
    assert clip == (grad_scale > 1)
    np.testing.assert_allclose(gn_t.item(), float(gn_r), rtol=1e-6)
    assert int(s_t["count"]) == int(s_r["count"]) == 3
    for k in params:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_r[k]), rtol=1e-6, atol=1e-7)
        for key in ("m", "v"):
            assert s_t[key][k].dtype == tdt
            rtol = 1e-6 if state_dtype == "float32" else 2.0**-7
            np.testing.assert_allclose(s_t[key][k].float().numpy(),
                                       np.asarray(s_r[key][k], np.float32), rtol=rtol, atol=1e-12)


def test_global_norm_and_init_opt_state_match_reference():
    params, grads, _, _ = _opt_inputs(5, 1.0)
    want = ropt.global_norm({k: jnp.asarray(x) for k, x in grads.items()})
    got = topt.global_norm({k: _t(x) for k, x in grads.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for sd in ("float32", "bfloat16"):
        st = topt.init_opt_state({k: _t(x) for k, x in params.items()}, topt.AdamWConfig(state_dtype=sd))
        sr = ropt.init_opt_state(params, ropt.AdamWConfig(state_dtype=sd))
        assert int(st["count"]) == int(sr["count"]) == 0 and st["count"].dtype == torch.int32
        for key in ("m", "v"):
            assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in st[key].items()} \
                == {k: (a.shape, str(a.dtype)) for k, a in sr[key].items()}
            assert all(not t.any() for t in st[key].values())


def test_adamw_update_refuses_mismatched_grads():
    p = {"a": torch.zeros(3)}
    with pytest.raises(ValueError):
        topt.adamw_update(p, {"b": torch.zeros(3)}, topt.init_opt_state(p, topt.AdamWConfig()),
                          1e-3, topt.AdamWConfig())


# ---------------------------------------------------------------------- xent
XENT_CASES = [  # real_vocab, vp, tile, logit_scale, pad_rows
    (80, 80, 16, 1.0, 0),
    (53, 80, 32, 1.0, 3),   # padded vocab; tile does not divide Vp
    (70, 96, 96, 0.0625, 2),
    (37, 80, 8, 2.0, 0),
]


def _xent_inputs(seed, vp, real_vocab, pad_rows):
    rng = np.random.default_rng(seed)
    b, s, d = 2, 5, 8
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((vp, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, real_vocab, (b, s)).astype(np.int32)
    labels.reshape(-1)[:pad_rows] = -1
    return x, w, labels


@pytest.mark.parametrize("real_vocab,vp,tile,scale,pad", XENT_CASES)
def test_vocab_parallel_xent_value_and_grads_match_reference(real_vocab, vp, tile, scale, pad):
    x, w, labels = _xent_inputs(real_vocab + tile, vp, real_vocab, pad)

    def ref_loss(x, w):
        return rxent.vocab_parallel_xent(x, w, jnp.asarray(labels), real_vocab, mesh=None,
                                         tile=tile, logit_scale=scale)

    want, (gx, gw) = jax.value_and_grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    got = txent.vocab_parallel_xent(xt, wt, _t(labels), real_vocab, tile=tile, logit_scale=scale)
    dx, dw = torch.autograd.grad(got, [xt, wt])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gw), atol=1e-5)
    # the plain form on materialised logits agrees too, in both packages
    logits = np.einsum("bsd,vd->bsv", x, w) * scale
    plain_r = rxent.sharded_xent(jnp.asarray(logits), jnp.asarray(labels), real_vocab)
    plain_t = txent.sharded_xent(_t(logits), _t(labels), real_vocab)
    np.testing.assert_allclose(plain_t.item(), float(plain_r), rtol=1e-5)
    np.testing.assert_allclose(got.item(), plain_t.item(), rtol=1e-5)


def test_xent_all_padding_labels_give_zero_loss_and_grads():
    x, w, _ = _xent_inputs(0, 80, 80, 0)
    labels = np.full((2, 5), -1, np.int32)
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    got = txent.vocab_parallel_xent(xt, wt, _t(labels), 80, tile=16)
    dx, dw = torch.autograd.grad(got, [xt, wt])
    assert got.item() == 0.0 == float(rxent.vocab_parallel_xent(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), 80, mesh=None, tile=16))
    assert not dx.any() and not dw.any()
    assert txent.sharded_xent(_t(x @ w.T), _t(labels), 80).item() == 0.0


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,seed,step", [("starcoder2_3b", 0, 0), ("minicpm_2b", 7, 11),
                                            ("command_r_35b", 3, 4096)])
def test_synthetic_stream_equals_reference(arch, seed, step):
    want = rtrain.SyntheticStream(rconfigs.get_smoke(arch),
                                  rtrain.DataConfig(seed=seed, batch=3, seq=40)).batch_at(step)
    got = ttrain.SyntheticStream(tconfigs.get_smoke(arch), ttrain.DataConfig(seed=seed, batch=3, seq=40),
                                 device="cpu").batch_at(step)
    assert got.keys() == want.keys() == {"tokens", "labels"}
    for key in got:
        assert got[key].dtype == torch.int32 and got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ----------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch", GRAD_ARCHS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused_xent", "logits_xent"])
def test_loss_and_grad_tree_match_reference(arch, fused):
    cfg_r, cfg_t, params, model = _pair(arch)
    batch = rtrain.SyntheticStream(cfg_r, rtrain.DataConfig(seed=1, batch=2, seq=64)).batch_at(3)
    kw = dict(attn_chunk=16, xent_tile=128, fused_xent=fused)
    (want, aux_r), grads_r = jax.value_and_grad(rtrain.loss_fn, has_aux=True)(
        params, cfg_r, rtrain.TrainConfig(**kw), batch)
    got, aux_t = ttrain.loss_fn(model, cfg_t, ttrain.TrainConfig(**kw), _torch_batch(batch))
    names = [n for n, _ in model.named_parameters()]
    # grok's GeLU experts never read moe.gate: a zero gradient, as jax.grad's
    grads_t = torch.autograd.grad(got, [p for _, p in model.named_parameters()],
                                  allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for key in ("xent", "moe_aux"):
        np.testing.assert_allclose(aux_t[key].item(), float(aux_r[key]), rtol=1e-5)
    want_g = named_arrays(cfg_t, jax.tree.map(np.asarray, grads_r))
    assert sorted(want_g) == sorted(names)
    for name, g in zip(names, grads_t):
        np.testing.assert_allclose(g.numpy(), want_g[name], atol=GRAD_ATOL.get(arch, 1e-6),
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_same_grads(remat):
    _, cfg_t, _, model = _pair("starcoder2_3b")
    batch = ttrain.SyntheticStream(cfg_t, ttrain.DataConfig(seed=2, batch=2, seq=64),
                                   device="cpu").batch_at(0)
    tcfg = ttrain.TrainConfig(attn_chunk=16, xent_tile=128)
    params = [p for _, p in model.named_parameters()]

    def grads(cfg):
        loss, _ = ttrain.loss_fn(model, cfg, tcfg, batch)
        return loss, torch.autograd.grad(loss, params)

    l0, g0 = grads(dataclasses.replace(cfg_t, remat="none"))
    l1, g1 = grads(dataclasses.replace(cfg_t, remat=remat))
    assert l0.item() == l1.item()
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


def test_remat_policies_recompute_what_they_drop():
    """Forward plus backward, ops counted as they run: ``full`` runs the
    blocks' dense products (``mm``) again in backward, ``dots`` keeps them and
    recomputes attention's batched products (``bmm``) only."""
    _, cfg_t, _, model = _pair("starcoder2_3b")
    batch = ttrain.SyntheticStream(cfg_t, ttrain.DataConfig(batch=2, seq=64), device="cpu").batch_at(0)
    params = [p for _, p in model.named_parameters()]
    counts = {}
    for remat in ("none", "dots", "full"):
        with _CountOps() as c:
            loss, _ = ttrain.loss_fn(model, dataclasses.replace(cfg_t, remat=remat),
                                     ttrain.TrainConfig(attn_chunk=16, xent_tile=128), batch)
            torch.autograd.grad(loss, params)
        counts[remat] = (c.n.get(torch.ops.aten.mm.default, 0), c.n.get(torch.ops.aten.bmm.default, 0))
    (mm_none, bmm_none), (mm_dots, bmm_dots), (mm_full, bmm_full) = (
        counts["none"], counts["dots"], counts["full"])
    assert mm_dots == mm_none < mm_full
    assert bmm_none < bmm_dots == bmm_full


class _CountOps(TorchDispatchMode):
    """Counts every aten op that runs while it is active, backward included."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_chunked_attention_checkpoints_each_chunk_under_grad():
    """Under autograd each KV block is checkpointed: the same output and
    gradients as the plain loop over ``_stream_block``, and backward computes
    each block's scores again."""
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((2, 32, 2, 3, 8)).astype(np.float32)).requires_grad_(True)
    k = _t(rng.standard_normal((2, 32, 2, 8)).astype(np.float32)).requires_grad_(True)
    v = _t(rng.standard_normal((2, 32, 2, 8)).astype(np.float32)).requires_grad_(True)

    def plain():
        m = torch.full((2, 2, 3, 32, 1), ref.NEG_INF)
        l, acc = torch.zeros((2, 2, 3, 32, 1)), torch.zeros((2, 2, 3, 32, 8))
        for k0 in range(0, 32, 8):
            m, l, acc = ref._stream_block(m, l, acc, q, k[:, k0:k0 + 8], v[:, k0:k0 + 8], k0,
                                          True, None)
        return (acc / torch.clamp(l, min=1e-30)).permute(0, 3, 1, 2, 4)

    out = {}
    for name, fn in (("plain", plain),
                     ("streamed", lambda: ref.streaming_attention(q, k, v, causal=True, block=8))):
        with _CountOps() as c:
            o = fn()
            grads = torch.autograd.grad(o.square().sum(), [q, k, v])
        out[name] = (o, grads, c.n.get(torch.ops.aten.bmm.default, 0))
    torch.testing.assert_close(out["streamed"][0], out["plain"][0], rtol=0, atol=0)
    for a, b in zip(out["streamed"][1], out["plain"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # backward recomputes each of the 4 blocks' scores (QK^T); the recompute
    # stops there, as PV's output is not needed again
    assert out["streamed"][2] == out["plain"][2] + 4
    # the model's chunked path: the same output with and without autograd
    with torch.no_grad():
        frozen = tattn._chunked_attention(q, k, v, causal=True, chunk=8)
    torch.testing.assert_close(tattn._chunked_attention(q, k, v, causal=True, chunk=8), frozen,
                               rtol=0, atol=0)


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    cfg_r, cfg_t, params, model = _pair("minicpm_2b")
    batch = rtrain.SyntheticStream(cfg_r, rtrain.DataConfig(batch=4, seq=32)).batch_at(0)
    tc_r = rtrain.TrainConfig(microbatches=microbatches)
    tc_t = ttrain.TrainConfig(microbatches=microbatches)
    opt_r = ropt.init_opt_state(params, tc_r.optimizer)
    p_r, o_r, m_r = jax.jit(rtrain.make_train_step(cfg_r, tc_r))(params, opt_r, batch, 5)
    opt_t = ttrain.init_opt_state(model, tc_t.optimizer)
    model_out, o_t, m_t = ttrain.make_train_step(cfg_t, tc_t)(model, opt_t, _torch_batch(batch), 5)
    assert model_out is model and o_t is opt_t
    assert set(m_t) == set(m_r) == {"loss", "lr", "grad_norm", "xent", "moe_aux"}
    for key in m_t:
        np.testing.assert_allclose(m_t[key].item(), float(m_r[key]), rtol=1e-5, err_msg=key)
    want = named_arrays(cfg_t, jax.tree.map(np.asarray, p_r))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2e-5, err_msg=name)
    want_opt = opt_state_from_jax(cfg_t, jax.tree.map(np.asarray, o_r), device="cpu")
    assert int(o_t["count"]) == int(want_opt["count"]) == 1
    # the moments carry the gradients' atol 1e-6: m = (1 - b1) g, so 1e-7;
    # v = (1 - b2) g^2 moves by 2 (1 - b2) |g| 1e-6 <= 1e-8 at |g| <= 0.1
    for key, atol in (("m", 1e-7), ("v", 1e-8)):
        for name, t in o_t[key].items():
            np.testing.assert_allclose(t.numpy(), want_opt[key][name].numpy(),
                                       rtol=1e-5, atol=atol, err_msg=f"{key} {name}")


def test_microbatched_step_accumulates_bf16_grads_in_f32():
    """bf16 parameters: microbatches 1 and 2 agree as closely as the
    reference's own pair does, and the accumulator never touches ``.grad``."""
    _, cfg_t, _, model = _pair("starcoder2_3b", dtype="bfloat16")
    batch = ttrain.SyntheticStream(cfg_t, ttrain.DataConfig(batch=4, seq=32), device="cpu").batch_at(1)
    state = {k: p.detach().clone() for k, p in model.named_parameters()}
    metrics = {}
    for mb in (1, 2):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(state[k])
        tcfg = ttrain.TrainConfig(microbatches=mb)
        opt = ttrain.init_opt_state(model, tcfg.optimizer)
        _, _, metrics[mb] = ttrain.make_train_step(cfg_t, tcfg)(model, opt, batch, 50)
        assert all(p.grad is None for p in model.parameters())
    np.testing.assert_allclose(metrics[2]["loss"].item(), metrics[1]["loss"].item(), rtol=1e-2)
    np.testing.assert_allclose(metrics[2]["grad_norm"].item(), metrics[1]["grad_norm"].item(),
                               rtol=2e-2)


def test_train_step_refuses_frozen_parameters_and_ragged_microbatches():
    cfg = tconfigs.get_smoke("starcoder2_3b")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import backbone

    frozen = backbone.init_model(cfg, generator=gen, device="cpu")
    batch = ttrain.SyntheticStream(cfg, ttrain.DataConfig(batch=3, seq=16), device="cpu").batch_at(0)
    tcfg = ttrain.TrainConfig()
    with pytest.raises(ValueError, match="require grad"):
        ttrain.make_train_step(cfg, tcfg)(frozen, ttrain.init_opt_state(frozen, tcfg.optimizer),
                                          batch, 0)
    model, opt = ttrain.init_train_state(gen, cfg, tcfg, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.make_train_step(cfg, ttrain.TrainConfig(microbatches=2))(model, opt, batch, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_falls_over_steps(seed):
    """12 steps on one batch of the stream: the loss must fall well below
    where it started.  (Over 12 fresh batches at this size the loss moves by
    less than the batches differ, in the reference as in the port; the step
    itself is held to the reference above.)"""
    cfg = tconfigs.get_smoke("starcoder2_3b")
    tcfg = ttrain.TrainConfig(schedule=ttrain.ScheduleConfig(kind="constant", peak_lr=1e-3,
                                                             warmup_steps=2))
    model, opt = ttrain.init_train_state(torch.Generator().manual_seed(seed), cfg, tcfg,
                                         device="cpu")
    batch = ttrain.SyntheticStream(cfg, ttrain.DataConfig(batch=4, seq=64), device="cpu").batch_at(0)
    step = ttrain.make_train_step(cfg, tcfg)
    losses = []
    for i in range(12):
        model, opt, m = step(model, opt, batch, i)
        losses.append(m["loss"].item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5


def test_opt_state_from_jax_copies_bits():
    cfg_r, cfg_t, params, _ = _pair("starcoder2_3b", dtype="bfloat16")
    rng = np.random.default_rng(0)
    opt = ropt.init_opt_state(params, ropt.AdamWConfig(state_dtype="bfloat16"))
    opt = {"m": jax.tree.map(lambda z: jnp.asarray(rng.standard_normal(z.shape), z.dtype), opt["m"]),
           "v": jax.tree.map(lambda z: jnp.asarray(rng.random(z.shape), z.dtype), opt["v"]),
           "count": jnp.asarray(9, jnp.int32)}
    np_opt = jax.tree.map(np.asarray, opt)
    got = opt_state_from_jax(cfg_t, np_opt, device="cpu")
    assert int(got["count"]) == 9 and got["count"].dtype == torch.int32
    model_names = {n for n, _ in params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                                                 device="cpu").named_parameters()}
    for key in ("m", "v"):
        want = named_arrays(cfg_t, np_opt[key])
        assert set(got[key]) == set(want) == model_names
        for name, t in got[key].items():
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.ascontiguousarray(want[name]).view(np.int16))
