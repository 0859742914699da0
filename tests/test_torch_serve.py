"""Port parity: serving.

With the JAX package's weights carried across at f32, the port's
``ServeEngine`` must produce the reference engine's greedy tokens exactly
(prefill through decode steps, then ``generate`` at temperature 0), its
prefill logits at atol 1e-4, and the same ``serve.tokens.*`` counters.
``make_prefill_step`` must match the reference's at atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import obs as robs
from repro.models import backbone as rbb
from repro.serve import ServeEngine as JaxEngine
from repro.serve import make_prefill_step as jax_prefill_step

from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import ServeEngine, make_decode_step, make_prefill_step, sample_token
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DENSE = ["starcoder2_3b", "starcoder2_7b", "minicpm_2b", "command_r_35b"]


def _pair(arch, seed=0):
    cfg_r = dataclasses.replace(rconfigs.get_smoke(arch), param_dtype="float32")
    cfg_t = dataclasses.replace(tconfigs.get_smoke(arch), param_dtype="float32")
    params, _ = rbb.init_model(jax.random.key(seed), cfg_r)
    return cfg_r, cfg_t, params, params_from_jax(cfg_t, jax.tree.map(np.asarray, params),
                                                 device="cpu")


def _counters(tr):
    return {k: tr.counter_value(k) for k in ("serve.tokens.prefill", "serve.tokens.decode")}


@pytest.mark.parametrize("arch", DENSE)
def test_engine_greedy_tokens_equal_reference(arch):
    cfg_r, cfg_t, params, model = _pair(arch)
    prompts = np.random.default_rng(2).integers(0, cfg_r.vocab, size=(2, 5), dtype=np.int32)
    ref = JaxEngine(cfg_r, params, batch=2, kv_len=16)
    port = ServeEngine(cfg_t, model, batch=2, kv_len=16, device="cpu")
    with robs.tracing("ref") as tr_r:
        want_logits = ref.prefill(jnp.asarray(prompts))
        want = np.asarray(ref.generate(6))
        want2 = np.asarray(ref.generate(3))  # starts from the last logits
    with tobs.tracing("port") as tr_t:
        got_logits = port.prefill(torch.from_numpy(prompts))
        got = port.generate(6)
        got2 = port.generate(3)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got2.numpy(), want2)
    assert port.position == ref.position == 14
    assert _counters(tr_t) == _counters(tr_r) == {"serve.tokens.prefill": 10,
                                                  "serve.tokens.decode": 18}
    names_t = sorted(s.name for s in tr_t.spans)
    names_r = sorted(s.name for s in tr_r.spans)
    assert names_t == names_r


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_step_matches_reference(arch):
    cfg_r, cfg_t, params, model = _pair(arch)
    toks = np.random.default_rng(3).integers(0, cfg_r.vocab, size=(2, 24), dtype=np.int32)
    want = jax_prefill_step(cfg_r, chunk=8)(params, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(cfg_t, chunk=8, device="cpu")(model, {"tokens": toks})
    assert got.shape == (2, cfg_t.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_steps_refuse_a_model_on_another_device():
    _, cfg_t, _, model = _pair("starcoder2_3b")
    with pytest.raises(ValueError, match="lies on"):
        make_prefill_step(cfg_t, device="meta")(model, {"tokens": np.zeros((1, 4), np.int32)})
    with pytest.raises(ValueError, match="lies on"):
        make_decode_step(cfg_t, device="meta")(model, {}, np.zeros((1, 1), np.int32), 0)


def test_sample_token():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 0.0, 0.0]])
    assert sample_token(None, logits).tolist() == [1, 0]  # first max, as jnp.argmax
    g = torch.Generator()
    g.manual_seed(0)
    draws = sample_token(g, logits * 100, temperature=1.0)
    assert draws.dtype == torch.int32 and draws.tolist()[1] == 0
    assert set(draws.tolist()) <= {0, 1, 2, 3}


def test_decode_past_the_end_of_the_kv_cache_matches_reference():
    """Past ``kv_len`` the new key and value land on the cache's last slot,
    as the reference's clamped ``dynamic_update_slice`` writes them."""
    cfg_r, cfg_t, params, model = _pair("starcoder2_3b")
    prompts = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.int32)
    ref = JaxEngine(cfg_r, params, batch=2, kv_len=4)
    port = ServeEngine(cfg_t, model, batch=2, kv_len=4, device="cpu")
    ref.prefill(jnp.asarray(prompts))
    port.prefill(torch.from_numpy(prompts))
    want = np.asarray(ref.generate(3))
    got = port.generate(3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port.position == ref.position == 6
