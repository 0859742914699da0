"""Port parity: GF(2^8) data path (``repro_torch.core.gf_torch``, the kernel
wrapper and ``kernels.ops``) against the JAX package's ``gf_jax``, numpy
``gf.gf_matmul`` and the Pallas kernel in interpret mode.

Every quantity is GF(256) bytes, so the tolerance is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import gf as rgf
from repro.core import gf_jax
from repro.kernels import ops as rops
from repro.kernels.gf_matmul import gf_matmul_pallas

from repro_torch import obs
from repro_torch.core import gf_torch
from repro_torch.core.codes import DRCFamily1
from repro_torch.kernels import ops
from repro_torch.kernels.gf_matmul import gf_matmul_batched

# tests/test_kernels.py SHAPES plus the ragged widths B = 17 and 333
SHAPES = [
    (1, 1, 128),
    (2, 3, 128),
    (3, 6, 256),
    (4, 12, 384),
    (9, 18, 512),
    (8, 27, 1024),
    (16, 64, 2048),
    (27, 162, 512),
    (3, 6, 17),
    (3, 6, 333),
]


def _rand(rng, r, k, b):
    m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    x = rng.integers(0, 256, size=(k, b), dtype=np.uint8)
    return m, x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("r,k,b", SHAPES)
def test_matmul_table_matches_jax_and_numpy(r, k, b):
    rng = np.random.default_rng(r * 1000 + k * 10 + b)
    m, x = _rand(rng, r, k, b)
    got = gf_torch.gf_matmul_table(_t(m), _t(x)).numpy()
    want = np.asarray(gf_jax.gf_matmul_jnp(jnp.asarray(m), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rgf.gf_matmul(m, x))


@pytest.mark.parametrize("r,k,b", SHAPES)
def test_ops_gf_matmul_cpu_matches_reference_ops(r, k, b):
    rng = np.random.default_rng(7 + r * 1000 + k * 10 + b)
    m, x = _rand(rng, r, k, b)
    got = ops.gf_matmul(m, _t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(rops.gf_matmul(m, jnp.asarray(x))))


@pytest.mark.parametrize("block_b", [128, 256, 512])
def test_ops_gf_matmul_matches_pallas_interpret(block_b):
    rng = np.random.default_rng(block_b)
    m, x = _rand(rng, 6, 9, 1024)
    np.testing.assert_array_equal(ops.bit_expand(m), rops.bit_expand(m))
    want = np.asarray(gf_matmul_pallas(jnp.asarray(rops.bit_expand(m)), jnp.asarray(x),
                                       block_b=block_b, interpret=True))
    np.testing.assert_array_equal(ops.gf_matmul(m, _t(x)).numpy(), want)


def test_gf_mul_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, size=(64, 33), dtype=np.uint8)
    b = rng.integers(0, 256, size=(1, 33), dtype=np.uint8)  # broadcasting
    got = gf_torch.gf_mul(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(gf_jax.gf_mul(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got, rgf.gf_mul(a, b))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_xor_reduce_matches_jax(axis):
    x = np.random.default_rng(2).integers(0, 256, size=(5, 7, 9), dtype=np.uint8)
    got = gf_torch.xor_reduce(_t(x), axis=axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(gf_jax.xor_reduce(jnp.asarray(x), axis=axis)))


def test_bits_roundtrip_matches_jax():
    x = np.random.default_rng(3).integers(0, 256, size=(4, 3, 77), dtype=np.uint8)
    bits = gf_torch.bytes_to_bits(_t(x))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(gf_jax.bytes_to_bits(jnp.asarray(x))))
    back = gf_torch.bits_to_bytes(bits).numpy()
    np.testing.assert_array_equal(back, np.asarray(gf_jax.bits_to_bytes(jnp.asarray(bits.numpy()))))
    np.testing.assert_array_equal(back, x)


def test_linearity_over_payload():
    rng = np.random.default_rng(7)
    m, x = _rand(rng, 4, 8, 256)
    y = rng.integers(0, 256, size=x.shape, dtype=np.uint8)
    lhs = ops.gf_matmul(m, _t(x ^ y))
    rhs = ops.gf_matmul(m, _t(x)) ^ ops.gf_matmul(m, _t(y))
    assert torch.equal(lhs, rhs)


def test_encode_payload_systematic():
    code = DRCFamily1(9, 6)
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=(code.k * code.alpha, 256), dtype=np.uint8)
    coded = ops.encode_payload(code.generator, _t(data)).numpy()
    np.testing.assert_array_equal(coded[: data.shape[0]], data)
    np.testing.assert_array_equal(coded, rgf.gf_matmul(code.generator, data))
    np.testing.assert_array_equal(
        coded, np.asarray(rops.encode_payload(code.generator, jnp.asarray(data))))


def test_out_is_written_in_place():
    rng = np.random.default_rng(9)
    m, x = _rand(rng, 3, 6, 300)
    buf = torch.full((5, 300), 7, dtype=torch.uint8)
    ops.gf_matmul(m, _t(x), out=buf[1:4])
    np.testing.assert_array_equal(buf[1:4].numpy(), rgf.gf_matmul(m, x))
    assert bool((buf[0] == 7).all()) and bool((buf[4] == 7).all())


def test_batched_cpu_path_runs_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(10)
    m = rng.integers(0, 256, size=(9, 4, 3), dtype=np.uint8)
    x = rng.integers(0, 256, size=(9, 3, 200), dtype=np.uint8)
    before = gf_matmul_batched.launches
    got = gf_matmul_batched(_t(m), _t(x)).numpy()
    assert gf_matmul_batched.launches == before
    for g in range(9):
        np.testing.assert_array_equal(got[g], rgf.gf_matmul(m[g], x[g]))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "out"])
def test_wrapper_rejects_bad_inputs(bad):
    m = torch.zeros((2, 3, 4), dtype=torch.uint8)
    x = torch.zeros((2, 4, 32), dtype=torch.uint8)
    out = None
    if bad == "dtype":
        x = x.int()
    elif bad == "shape":
        x = torch.zeros((2, 5, 32), dtype=torch.uint8)
    elif bad == "contiguity":
        x = torch.zeros((2, 32, 4), dtype=torch.uint8).transpose(1, 2)
    else:
        out = torch.zeros((2, 3, 31), dtype=torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        gf_matmul_batched(m, x, out)


def test_traced_kernel_span_and_counters_match_reference():
    rng = np.random.default_rng(11)
    m, x = _rand(rng, 3, 6, 256)
    with obs.tracing("port") as tr:
        ops.gf_matmul(m, _t(x))
    with robs.tracing("ref") as rtr:
        rops.gf_matmul(m, jnp.asarray(x))
    (span,) = tr.spans_named("kernel.gf_matmul")
    assert span.attrs["path"] == "ref" and (span.attrs["r"], span.attrs["k"]) == (3, 6)
    for name in ("kernel.gf_matmul.bytes", "kernel.gf_matmul.calls"):
        assert tr.counter_value(name, path="ref") == rtr.counter_value(name, path="ref")
