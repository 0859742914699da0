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
from repro_torch.kernels.ref import gf_matmul_bitsliced

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


def test_custom_op_on_fake_card_tensors_returns_fake_output_and_launches_nothing():
    """``repro_torch::gf_matmul`` on fake ``cuda`` tensors: the wrapper takes
    the custom op's fake kernel, returns a fake (G, R, B) uint8 output on the
    card and counts no launch."""
    from torch._subclasses.fake_tensor import is_fake

    from repro_torch.check.traced.capture import fake_cuda, fake_mode

    before = gf_matmul_batched.launches
    with fake_cuda(), fake_mode():
        m = torch.empty((9, 4, 3), dtype=torch.uint8, device="cuda")
        x = torch.empty((9, 3, 200), dtype=torch.uint8, device="cuda")
        y = gf_matmul_batched(m, x)
        z = ops.gf_matmul(np.ones((4, 3), dtype=np.uint8), x[0])
    assert is_fake(y) and is_fake(z)
    assert (tuple(y.shape), y.dtype, y.device.type) == ((9, 4, 200), torch.uint8, "cuda")
    assert (tuple(z.shape), z.dtype) == ((4, 200), torch.uint8)
    assert gf_matmul_batched.launches == before
    schema = str(torch.ops.repro_torch.gf_matmul.default._schema)
    assert schema == "repro_torch::gf_matmul(Tensor m, Tensor x, Tensor(a2!) out) -> ()"


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
    assert span.attrs == {"path": "ref", "r": 3, "k": 6, "b": 256, "g": 1}
    assert span.cat == "kernel" and span.parent_id is None and span.dur_us > 0
    for name in ("kernel.gf_matmul.bytes", "kernel.gf_matmul.calls"):
        assert tr.counter_value(name, path="ref") == rtr.counter_value(name, path="ref")
    assert not tr.metrics.gauges


class _OnCard(torch.Tensor):
    """A host payload that says it lies on the card."""

    @property
    def is_cuda(self):
        return True


def test_traced_gf_matmul_never_synchronises_and_nests_in_its_caller(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(a))
    monkeypatch.setattr(ops._kernel, "gf_matmul_batched",
                        lambda m, x, out: torch.zeros((m.shape[0], m.shape[1], x.shape[2]),
                                                      dtype=torch.uint8))
    m, x = _rand(np.random.default_rng(12), 3, 6, 256)
    x = _t(x).as_subclass(_OnCard)
    with obs.tracing("port") as tr:
        with obs.span("caller") as caller:
            ops.gf_matmul(m, x)
            ops.gf_matmul_batched(m[None], x[None])
    assert syncs == []
    spans = tr.spans_named("kernel.gf_matmul")
    assert len(spans) == 2
    for span in spans:
        assert span.parent_id == caller.span_id and span.track == caller.track
        assert caller.start_us <= span.start_us
        assert span.start_us + span.dur_us <= caller.start_us + caller.dur_us
        assert span.attrs["path"] == "cuda" and "gbps" not in span.attrs
    assert tr.counter_value("kernel.gf_matmul.calls", path="cuda") == 2
    assert tr.counter_value("kernel.gf_matmul.bytes", path="cuda") == 2 * (6 + 3) * 256


def test_bitsliced_model_every_coefficient():
    """The kernel's CPU model, a 1x1 product per coefficient over every byte."""
    x = np.arange(256, dtype=np.uint8)[None]
    for c in range(256):
        m = np.array([[c]], dtype=np.uint8)
        got = gf_matmul_bitsliced(m, _t(x)).numpy()
        np.testing.assert_array_equal(got, rgf.gf_matmul(m, x), err_msg=f"c={c}")
        np.testing.assert_array_equal(
            got, np.asarray(gf_jax.gf_matmul_jnp(jnp.asarray(m), jnp.asarray(x))))


@pytest.mark.parametrize("r,k,b", SHAPES + [(3, 6, b) for b in (1, 31, 33)])
def test_bitsliced_model_matches_jax_and_numpy(r, k, b):
    rng = np.random.default_rng(13 + r * 1000 + k * 10 + b)
    m, x = _rand(rng, r, k, b)
    got = gf_matmul_bitsliced(m, _t(x)).numpy()
    np.testing.assert_array_equal(got, rgf.gf_matmul(m, x))
    np.testing.assert_array_equal(
        got, np.asarray(gf_jax.gf_matmul_jnp(jnp.asarray(m), jnp.asarray(x))))


def test_gf_ablation_variants_are_edits_of_the_kernel_source():
    from repro_torch.kernels import build, gf_ablation

    src = build.SOURCES["gf_matmul"].read_text()
    out = gf_ablation.variant_sources(diagnostics=True)
    assert set(out) == {"swar", "no_ring", "predicated", "final", "no_load", "no_compute"}
    assert out["final"] == src
    assert out["swar"] == (build.CSRC / "gf_matmul_swar.cu").read_text()
    assert "gf_matmul_swar" not in str(build.SOURCES)  # only the ablation builds it
    for name in ("no_ring", "predicated", "no_load", "no_compute"):
        (step,) = {**gf_ablation.VARIANTS, **gf_ablation.DIAGNOSTICS}[name]
        text = src
        for old, new in gf_ablation.EDITS[step]:
            assert src.count(old) == 1
            text = text.replace(old, new)
        assert out[name] == text != src
    # the shipped source has one path: no design switch, and neither
    # alternative body
    for old, new in gf_ablation.EDITS["ring"] + gf_ablation.EDITS["branch"]:
        assert new == "" or new not in src
    assert "constexpr bool" not in src
    with pytest.raises(RuntimeError, match="no_ring"):
        gf_ablation.apply_edits(src, [("no such text", "")], "no_ring")


def _fake_sass(case_lops):
    """A kernel listing shaped like the bitsliced kernel's inner loop: the
    head of a work list, 5 instructions, the entry loop (4 instructions, a
    BRX and its cases, another BRX and its cases, 3 instructions and the
    back branch)."""
    ins = ["LDS.U16 R1, [R2]"] + ["IADD3 R3, R3, 0x1, RZ"] * 5
    entry = len(ins)
    ins += ["LDS.U16 R4, [R5]", "LDS.128 R8, [R6]", "LDS.128 R12, [R6+0x200]", "LDC R7, c[0x2][R7]"]
    for _ in range(2):
        ins.append("BRX R7 -0x10")
        start = len(ins)
        join = start + sum(n + 1 for n in case_lops) - 1  # the last case falls through
        for i, n in enumerate(case_lops):
            ins += ["LOP3.LUT R8, R8, R20, R21, 0x96, !PT"] * n
            if i < len(case_lops) - 1:
                ins.append(f"BRA 0x{join * 16:x}")
        ins.append("SHF.R.U32.HI R7, RZ, 0x4, R4")
    ins += ["STS.128 [R6], R8", "STS.128 [R6+0x200], R12", f"@P0 BRA 0x{entry * 16:x}", "EXIT"]
    lines = [f"        /*{16 * i:04x}*/                   {t} ;" for i, t in enumerate(ins)]
    return "Function : _Z19gf_bitsliced_kernelPKh\n" + "\n".join(lines) + "\n"


def test_sass_count_reads_the_inner_loop():
    from repro_torch.kernels.gf_ablation import sass_count

    lops = [8 * -(-bin(n).count("1") // 2) for n in range(1, 16)]
    m = np.array([[0x11, 0], [0, 0xF0], [0, 0]], dtype=np.uint8)  # (3, 2)
    got = sass_count(_fake_sass(lops), m)
    assert got["per_input_row"] == 6
    # 4 + BRX + SHF + BRX + SHF + 2 STS + back branch
    assert got["per_coefficient"] == 11
    assert got["case"] == [0] + [n + 1 for n in lops[:-1]] + [lops[-1]]
    # two columns, each with one coefficient: 0x11 (1 + 1 nibble), 0xF0 (15)
    want = 2 * 6 + (11 + 9 + 9) + (11 + 0 + 16)
    assert got["instructions_per_32_bytes"] == want
    assert got["per_row_coefficient_byte"] == want / (3 * 2 * 32)
