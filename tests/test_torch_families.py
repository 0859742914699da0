"""Port parity: the model families beyond the dense one.

The JAX package's ``init_model`` draws the weights of the MoE (dbrx, grok),
ssm (xlstm), hybrid (zamba2), vlm (internvl2) and audio (whisper) smoke
configs; ``params_from_jax`` carries them into the port, and both packages
run the same numpy inputs.  At f32 the only differences are the order of
sums, so logits and the MoE aux loss must agree at atol/rtol 1e-4 (as
``test_torch_models.py``), through the full-sequence forward and through 8
decode steps, and every decode-state leaf (KV caches, Mamba2 ``h``/``conv``,
mLSTM ``c``, sLSTM ``h``/``c``/``n``, ``shared_kv``, the encoder output) at
atol/rtol 1e-5.  The MoE dispatch's integers must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import backbone as rbb
from repro.models import mamba2 as rm2
from repro.models import mlp as rmlp
from repro.models import xlstm as rxl
from repro.serve import ServeEngine as JaxEngine
from repro.serve import make_prefill_step as jax_prefill_step

from repro_torch import configs as tconfigs
from repro_torch.examples import serve_demo
from repro_torch.models import attention as tattn
from repro_torch.models import backbone as tbb
from repro_torch.models import mamba2 as tm2
from repro_torch.models import mlp as tmlp
from repro_torch.models import xlstm as txl
from repro_torch.models.weights import named_arrays, params_from_jax
from repro_torch.serve import ServeEngine, make_prefill_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ["dbrx_132b", "grok_1_314b", "xlstm_125m", "zamba2_1p2b", "internvl2_1b",
            "whisper_small"]
# prompt lengths: zamba2's SSD chunk is 32 (two chunks at 64); xlstm's mLSTM
# chunk is 256 (two chunks at 512)
SEQ = {"zamba2_1p2b": 64, "xlstm_125m": 512}
ATOL = RTOL = 1e-4
STATE_ATOL = STATE_RTOL = 1e-5


def _cfgs(arch, dtype="float32", **changes):
    cfg_r = dataclasses.replace(rconfigs.get_smoke(arch), param_dtype=dtype, **changes)
    cfg_t = dataclasses.replace(tconfigs.get_smoke(arch), param_dtype=dtype, **changes)
    return cfg_r, cfg_t


def _pair(arch, dtype="float32", seed=0, **changes):
    cfg_r, cfg_t = _cfgs(arch, dtype, **changes)
    params, _ = rbb.init_model(jax.random.key(seed), cfg_r)
    tree = jax.tree.map(np.asarray, params)
    return cfg_r, cfg_t, params, params_from_jax(cfg_t, tree, device="cpu")


def _drop_free(cfg):
    """A capacity factor at which no expert can overflow (k·cf/E >= 1)."""
    return {"moe": dataclasses.replace(cfg.moe, capacity_factor=8.0)} if cfg.moe else {}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _inputs(cfg, b, s, seed=1):
    """tokens (B, S) and the family's extra inputs, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, s), dtype=np.int32)}
    if cfg.family == "vlm":
        out["vis_embeds"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model),
                                                dtype=np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict/list state."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_leaves(tree[key], f"{prefix}{key}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_leaves(sub, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("arch", sorted(rconfigs.list_archs()))
def test_every_architecture_builds_with_the_reference_names(arch):
    cfg_r, cfg_t = _cfgs(arch, "bfloat16")
    g = torch.Generator()
    g.manual_seed(0)
    model = tbb.init_model(cfg_t, generator=g, device="cpu")
    params, _ = rbb.init_model(jax.random.key(0), cfg_r)
    arrays = named_arrays(cfg_t, jax.tree.map(np.asarray, params))
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in model.named_parameters()}
    want = {n: (tuple(a.shape), a.dtype.name) for n, a in arrays.items()}
    assert got == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_weights_carry_across_bit_exact(arch):
    cfg_r, cfg_t, params, model = _pair(arch, "bfloat16")
    arrays = named_arrays(cfg_t, jax.tree.map(np.asarray, params))
    assert arrays.keys() == dict(model.named_parameters()).keys()
    for name, p in model.named_parameters():
        want = np.ascontiguousarray(arrays[name])
        bits = (torch.int16, np.int16) if p.dtype == torch.bfloat16 else (torch.int32, np.int32)
        assert p.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(p.view(bits[0]).numpy(), want.view(bits[1]))


def test_init_model_distributions_of_the_new_parameters():
    g = torch.Generator()
    g.manual_seed(0)
    cfg = tconfigs.get_smoke("dbrx_132b")
    moe = tbb.init_model(cfg, generator=g, device="cpu").blocks[0].moe
    lim = 1 / np.sqrt(cfg.d_model)
    assert moe.router.w.dtype == torch.float32 and moe.router.w.shape == (128, 4)
    for w in (moe.up, moe.gate, moe.down):  # down too: the model width's limit
        assert w.dtype == torch.bfloat16 and float(w.float().abs().max()) <= lim
        assert float(w.float().abs().max()) > 0.9 * lim
    grok = tbb.init_model(tconfigs.get_smoke("grok_1_314b"), generator=g, device="cpu")
    assert grok.blocks[0].moe.gate.shape == (4, 128, 256)  # held for GeLU experts too
    cfg = tconfigs.get_smoke("zamba2_1p2b")
    model = tbb.init_model(cfg, generator=g, device="cpu")
    core = model.mamba_main[0].core
    assert core.conv.dtype == torch.bfloat16 and core.conv.shape == (4, 256)
    assert abs(float(torch.stack([m.core.conv for m in model.mamba_main]).float().std())
               - 0.02) < 0.002
    assert float(core.a_log.abs().max()) == 0.0 and core.a_log.dtype == torch.float32
    assert float(core.d_skip.min()) == float(core.d_skip.max()) == 1.0
    assert float(core.in_xz.w.float().abs().max()) <= 1 / np.sqrt(128)
    assert float(core.out.w.float().abs().max()) <= 1 / np.sqrt(256)
    xl = tbb.init_model(tconfigs.get_smoke("xlstm_125m"), generator=g, device="cpu")
    assert xl.blocks[0].core.wi.w.dtype == xl.blocks[0].core.wf.w.dtype == torch.float32
    assert isinstance(xl.blocks[3].core, txl.SLSTM) and isinstance(xl.blocks[2].core, txl.MLSTM)


# ------------------------------------------------------------------ modules
def test_moe_dispatch_matches_reference_where_tokens_drop():
    cfg_r, cfg_t = _cfgs("dbrx_132b")
    moe_r = dataclasses.replace(cfg_r.moe, capacity_factor=0.5)
    moe_t = dataclasses.replace(cfg_t.moe, capacity_factor=0.5)
    rng = np.random.default_rng(5)
    tokens = rng.standard_normal((64, cfg_t.d_model), dtype=np.float32)
    router = rng.standard_normal((cfg_t.d_model, 4), dtype=np.float32) * 0.3
    xs_r, info_r = rmlp._dispatch_local(jnp.asarray(tokens), jnp.asarray(router), moe_r, 2)
    xs_t, info_t = tmlp._dispatch_local(torch.from_numpy(tokens), torch.from_numpy(router),
                                        moe_t, 2)
    slot_r, t_r, g_r, keep_r, cap_r, aux_r = info_r
    slot_t, t_t, g_t, keep_t, cap_t, aux_t = info_t
    assert cap_t == cap_r == tmlp.capacity(moe_t, 64, 2) == 16
    assert not bool(keep_t.all())  # the capacity drops tokens
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_r))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_r))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_r))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_r), atol=1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-6)
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_r))
    ys = rng.standard_normal(tuple(xs_t.shape), dtype=np.float32)
    got = tmlp._combine_local(torch.from_numpy(ys), info_t, 64)
    want = rmlp._combine_local(jnp.asarray(ys), info_r, 64)
    # the gates differ by the f32 router product's rounding (sums over d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], dtype=np.float32)
    vals_r, idx_r = jax.lax.top_k(jnp.asarray(probs), 2)
    vals_t, idx_t = tmlp._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_r))


@pytest.mark.parametrize("n,k,e,cf", [(1, 4, 16, 1.25), (8, 4, 16, 1.25), (8192, 4, 16, 1.25),
                                      (100, 2, 8, 1.25), (37, 3, 5, 0.7)])
def test_moe_capacity_matches_reference(n, k, e, cf):
    moe_r = dataclasses.replace(rconfigs.get_config("dbrx_132b").moe, num_experts=e,
                                capacity_factor=cf)
    moe_t = dataclasses.replace(tconfigs.get_config("dbrx_132b").moe, num_experts=e,
                                capacity_factor=cf)
    tokens = jnp.ones((n, 4), jnp.float32)
    _, info = rmlp._dispatch_local(tokens, jnp.ones((4, e), jnp.float32), moe_r, k)
    assert tmlp.capacity(moe_t, n, k) == info[4]


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_layer_matches_reference(act):
    arch = "dbrx_132b" if act == "swiglu" else "grok_1_314b"
    cfg_r, cfg_t, params, model = _pair(arch)
    x = np.random.default_rng(2).standard_normal((2, 24, cfg_t.d_model), dtype=np.float32)
    want, aux_r = rmlp.moe_layer_with_loss(jax.tree.map(lambda a: a[0], params["blocks"])["moe"],
                                           cfg_r, jnp.asarray(x))
    got, aux_t = tmlp.moe_layer_with_loss(model.blocks[0].moe, cfg_t, torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-6)

    class DataOnlyMesh:  # no model axis: the local layer, as the reference's test for its SPMD path
        mesh_dim_names = ("data",)

        def size(self):
            return 2

    same, _ = tmlp.moe_layer_with_loss(model.blocks[0].moe, cfg_t, torch.from_numpy(x),
                                       mesh=DataOnlyMesh())
    assert torch.equal(same, got)


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 16), (32, 64)])
def test_ssd_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 3, 8), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, s, 3), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(3).astype(np.float32) * 0.3)
    b = rng.standard_normal((2, s, 5), dtype=np.float32)
    c = rng.standard_normal((2, s, 5), dtype=np.float32)
    want = rm2._ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk)
    got = tm2._ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_ssd_chunked_refuses_unequal_chunks():
    z = torch.zeros((1, 50, 2, 4))
    with pytest.raises(ValueError, match="equal chunks"):
        tm2._ssd_chunked(z, torch.zeros((1, 50, 2)), torch.zeros(2), torch.zeros((1, 50, 3)),
                         torch.zeros((1, 50, 3)), 16)


@pytest.mark.parametrize("s,chunk", [(64, 16), (32, 64)])
def test_mlstm_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, 2, 8), dtype=np.float32) for _ in range(3))
    log_f = -np.log1p(np.exp(-rng.standard_normal((2, s, 2), dtype=np.float32) - 2))
    log_i = -np.log1p(np.exp(-rng.standard_normal((2, s, 2), dtype=np.float32)))
    want = rxl._mlstm_chunked(*map(jnp.asarray, (q, k, v, log_f, log_i)), chunk)
    got = txl._mlstm_chunked(*map(torch.from_numpy, (q, k, v, log_f, log_i)), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sq,sk,chunk", [(8, 1500, 512), (5, 32, 8), (1, 1500, 512)])
def test_cross_attention_matches_reference(sq, sk, chunk):
    cfg_r, cfg_t, params, model = _pair("whisper_small")
    p_r = jax.tree.map(lambda a: a[0], params["blocks"])["xattn"]
    p_t = model.blocks[0].xattn
    rng = np.random.default_rng(sk)
    x = rng.standard_normal((2, sq, cfg_t.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, sk, cfg_t.d_model), dtype=np.float32)
    kv_r = rattn.cross_kv(p_r, cfg_r, jnp.asarray(enc))
    kv_t = tattn.cross_kv(p_t, cfg_t, torch.from_numpy(enc))
    for a, b in zip(kv_t, kv_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    want = rattn.attention(p_r, cfg_r, jnp.asarray(x), cross_kv=kv_r, chunk=chunk)
    got = tattn.attention(p_t, cfg_t, torch.from_numpy(x), cross_kv=kv_t, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ the models
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_aux_match_f32(arch):
    cfg_r, cfg_t, params, model = _pair(arch)
    batch = _inputs(cfg_t, 2, SEQ.get(arch, 32))
    want, aux_r = rbb.forward(params, cfg_r, _jax_batch(batch), chunk=8)
    with torch.no_grad():
        got, aux_t = tbb.forward(model, cfg_t, _torch_batch(batch), chunk=8)
    s = batch["tokens"].shape[1] + (cfg_t.vision_tokens if cfg_t.family == "vlm" else 0)
    assert got.shape == (2, s, cfg_t.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), atol=ATOL, rtol=RTOL)
    if cfg_t.moe:
        assert float(aux_t) > 0.0


def _decode_both(arch, steps=8):
    cfg_r, cfg_t, params, model = _pair(arch)
    batch = _inputs(cfg_t, 2, steps, seed=3)
    toks = batch["tokens"]
    state_r, _ = rbb.init_decode_state(cfg_r, 2, steps + 2)
    state_t = tbb.init_decode_state(cfg_t, 2, steps + 2, device="cpu")
    if cfg_t.family == "audio":
        state_r["enc"] = rbb._run_encoder(params, cfg_r, jnp.asarray(batch["frames"]))
        with torch.no_grad():
            state_t["enc"] = tbb._run_encoder(model, cfg_t, torch.from_numpy(batch["frames"]))
    got, want = [], []
    for pos in range(steps):
        lr, state_r = rbb.decode_step(params, cfg_r, state_r, jnp.asarray(toks[:, pos:pos + 1]),
                                      pos)
        with torch.no_grad():
            lt, state_t = tbb.decode_step(model, cfg_t, state_t,
                                          torch.from_numpy(toks[:, pos:pos + 1]), pos)
        want.append(_f32(lr))
        got.append(_f32(lt))
    return np.stack(got), np.stack(want), state_t, state_r


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_logits_and_state_match_f32(arch):
    got, want, state_t, state_r = _decode_both(arch)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    leaves_t, leaves_r = _leaves(state_t), _leaves(state_r)
    assert leaves_t.keys() == leaves_r.keys()
    for name, leaf in leaves_t.items():
        assert tuple(leaf.shape) == tuple(leaves_r[name].shape), name
        np.testing.assert_allclose(_f32(leaf), _f32(leaves_r[name]), atol=STATE_ATOL,
                                   rtol=STATE_RTOL, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward_in_port(arch):
    """The port's decode against its own full-sequence forward at f32 (MoE at
    a drop-free capacity: the forward's capacity counts all B·S tokens,
    decode's only B; vlm on text, its decode starts after any visual
    prefix; audio with the encoder's output set in the state)."""
    cfg = tconfigs.get_smoke(arch)
    cfg = dataclasses.replace(cfg, param_dtype="float32", **_drop_free(cfg))
    g = torch.Generator()
    g.manual_seed(0)
    model = tbb.init_model(cfg, generator=g, device="cpu")
    batch = _torch_batch(_inputs(cfg, 2, 8, seed=3))
    batch.pop("vis_embeds", None)
    state = tbb.init_decode_state(cfg, 2, 8, device="cpu")
    with torch.no_grad():
        full, _ = tbb.forward(model, cfg, batch)
        if cfg.family == "audio":
            state["enc"] = tbb._run_encoder(model, cfg, batch["frames"])
        for pos in range(8):
            step, state = tbb.decode_step(model, cfg, state, batch["tokens"][:, pos:pos + 1], pos)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, pos].numpy(), atol=ATOL,
                                       rtol=RTOL)


# bf16: both packages round activations to bf16 after every product, in
# different places (XLA fuses, PyTorch does not); the rounding differences
# (2^-8 relative) compound over the layers.  The logits must agree to 5% of
# the largest logit, as the dense family's.
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_bf16(arch):
    cfg_r, cfg_t, params, model = _pair(arch, "bfloat16")
    batch = _inputs(cfg_t, 2, SEQ.get(arch, 16))
    # jitted: op by op, XLA's CPU runtime has no bf16 x bf16 -> f32 dot (xlstm)
    want, _ = jax.jit(lambda p, b: rbb.forward(p, cfg_r, b))(params, _jax_batch(batch))
    with torch.no_grad():
        got, _ = tbb.forward(model, cfg_t, _torch_batch(batch))
    assert got.dtype == torch.bfloat16
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.parametrize("arch", ["internvl2_1b", "whisper_small"])
def test_prefill_step_passes_the_extra_inputs(arch):
    cfg_r, cfg_t, params, model = _pair(arch)
    batch = _inputs(cfg_t, 2, 16, seed=7)
    want = jax_prefill_step(cfg_r, chunk=8)(params, _jax_batch(batch))
    got = make_prefill_step(cfg_t, chunk=8, device="cpu")(model, batch)
    assert got.shape == (2, cfg_t.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["dbrx_132b", "zamba2_1p2b", "xlstm_125m"])
def test_engine_greedy_tokens_equal_reference(arch):
    cfg_r, cfg_t, params, model = _pair(arch)
    prompts = np.random.default_rng(2).integers(0, cfg_r.vocab, size=(2, 5), dtype=np.int32)
    ref = JaxEngine(cfg_r, params, batch=2, kv_len=16)
    port = ServeEngine(cfg_t, model, batch=2, kv_len=16, device="cpu")
    want_logits = ref.prefill(jnp.asarray(prompts))
    want = np.asarray(ref.generate(6))
    got_logits = port.prefill(torch.from_numpy(prompts))
    got = port.generate(6)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port.position == ref.position == 11


def test_engine_serves_whisper_with_the_encoder_state_set():
    cfg_r, cfg_t, params, model = _pair("whisper_small")
    batch = _inputs(cfg_t, 2, 5, seed=4)
    ref = JaxEngine(cfg_r, params, batch=2, kv_len=16)
    port = ServeEngine(cfg_t, model, batch=2, kv_len=16, device="cpu")
    ref.state["enc"] = rbb._run_encoder(params, cfg_r, jnp.asarray(batch["frames"]))
    with torch.no_grad():
        port.state["enc"] = tbb._run_encoder(model, cfg_t, torch.from_numpy(batch["frames"]))
    want_logits = ref.prefill(jnp.asarray(batch["tokens"]))
    got_logits = port.prefill(torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(port.generate(4).numpy(), np.asarray(ref.generate(4)))


def test_serve_demo_runs_on_the_cpu(capsys):
    out = serve_demo.main(["--device", "cpu"])
    assert list(out) == list(serve_demo.ARCHS)
    for arch, row in out.items():
        vocab = tconfigs.get_smoke(arch).vocab
        assert row["tokens"].shape == (4, 24) and row["tokens"].dtype == torch.int32
        assert 0 <= int(row["tokens"].min()) and int(row["tokens"].max()) < vocab
        assert row["prefill_logits_finite"] and row["position"] == 40
    assert "serve demo OK" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["xlstm_125m", "zamba2_1p2b"])
def test_bf16_decode_gap_matches_reference(arch):
    """In bf16 the recurrent families' decode departs from their chunked
    forward (each rounds to bf16 in other places); the port's departure at
    the last of 32 prompt positions must be about the reference's own (within
    1.5 times it, plus 0.5% of the largest logit), with 12 xLSTM layers."""
    layers = {"xlstm_125m": 12}.get(arch)
    changes = {"n_layers": layers} if layers else {}
    cfg_r, cfg_t, params, model = _pair(arch, "bfloat16", **changes)
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, size=(8, 32), dtype=np.int32)

    def gap(full, last):
        full, last = _f32(full)[:, -1], _f32(last)[:, 0]
        return np.abs(last - full).max() / np.abs(full).max()

    full_r, _ = jax.jit(lambda p, b: rbb.forward(p, cfg_r, b))(params, {"tokens": jnp.asarray(toks)})
    state_r, _ = rbb.init_decode_state(cfg_r, 8, 32)
    step = jax.jit(lambda p, s, x, t: rbb.decode_step(p, cfg_r, s, x, t))
    state_t = tbb.init_decode_state(cfg_t, 8, 32, device="cpu")
    with torch.no_grad():
        full_t, _ = tbb.forward(model, cfg_t, {"tokens": torch.from_numpy(toks)})
        for t in range(32):
            last_r, state_r = step(params, state_r, jnp.asarray(toks[:, t:t + 1]), t)
            last_t, state_t = tbb.decode_step(model, cfg_t, state_t,
                                              torch.from_numpy(toks[:, t:t + 1]), t)
    assert gap(full_t, last_t) <= 1.5 * gap(full_r, last_r) + 0.005
