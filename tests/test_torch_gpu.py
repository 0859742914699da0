"""Card-only tests of the port: the CUDA kernel and the paths it serves.

These tests import neither ``jax`` nor ``repro``, so they run on a machine
that has only PyTorch with CUDA.  Their reference is the port's plain table
version and its numpy plan layer, which ``tests/test_torch_gf.py`` and
``tests/test_torch_codes.py`` hold byte-equal to the JAX package.  Each test
skips itself where no card is present; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import gf
from repro_torch.core.codes import make_code
from repro_torch.core.gf_torch import gf_matmul_table
from repro_torch.dist import collectives
from repro_torch.kernels import ops
from repro_torch.kernels.gf_matmul import gf_matmul_batched
from repro_torch.train import checkpoint

pytestmark = pytest.mark.gpu

# tests/test_kernels.py SHAPES plus the ragged widths B = 17 and 333
SHAPES = [
    (1, 1, 128), (2, 3, 128), (3, 6, 256), (4, 12, 384), (9, 18, 512),
    (8, 27, 1024), (16, 64, 2048), (27, 162, 512), (3, 6, 17), (3, 6, 333),
]
SPMD_CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3), ("MSR", 9, 6, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(rng, *shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("r,k,b", SHAPES)
def test_kernel_matches_plain_and_launches(dev, r, k, b):
    rng = np.random.default_rng(r * 1000 + k * 10 + b)
    m, x = _rand(rng, r, k), _rand(rng, k, b)
    before = gf_matmul_batched.launches
    got = ops.gf_matmul(m, torch.from_numpy(x).to(dev))
    assert gf_matmul_batched.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), gf.gf_matmul(m, x))
    assert torch.equal(got, gf_matmul_table(torch.from_numpy(m).to(dev), torch.from_numpy(x).to(dev)))


def test_kernel_batched_into_unaligned_view(dev):
    rng = np.random.default_rng(12)
    m, x = _rand(rng, 5, 7, 9), _rand(rng, 5, 9, 333)
    out = torch.zeros((6, 7, 333), dtype=torch.uint8, device=dev)
    gf_matmul_batched(torch.from_numpy(m).to(dev), torch.from_numpy(x).to(dev), out[1:])
    for g in range(5):
        np.testing.assert_array_equal(out[g + 1].cpu().numpy(), gf.gf_matmul(m[g], x[g]))
    assert not bool(out[0].any())


@pytest.mark.parametrize("spec", SPMD_CODES, ids=lambda s: "%s%d%d%d" % s)
def test_repair_paths_on_card(dev, spec):
    code = make_code(*spec)
    rng = np.random.default_rng(3)
    data = _rand(rng, code.k * code.alpha, 4096)
    nodes = [gf.gf_matmul(code.node_coeffs(i), data) for i in range(code.n)]
    stacked = torch.from_numpy(np.stack(nodes)).to(dev)
    encoded = code.encode(torch.from_numpy(data).to(dev))
    for i in range(code.n):
        np.testing.assert_array_equal(encoded[i].cpu().numpy(), nodes[i])
    for failed in (0, code.n - 1):
        out, sp = collectives.spmd_repair(code, failed, stacked)
        np.testing.assert_array_equal(out[sp.target_pod * sp.w].cpu().numpy(), nodes[failed])
        plan = code.repair_plan(failed)
        got = plan.execute({i: stacked[i] for i in plan.participants()})
        np.testing.assert_array_equal(got.cpu().numpy(), nodes[failed])


def test_checkpoint_roundtrip_on_card(dev, tmp_path):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = {"w": torch.randn((37, 53), generator=g, device=dev),
             "nested": {"m": torch.randn((5, 7), generator=g, device=dev).bfloat16()},
             "b": torch.arange(11, dtype=torch.int32, device=dev)}
    mgr = checkpoint.CheckpointManager(str(tmp_path), device="cuda")
    mgr.save(1, state)
    os.remove(tmp_path / "step_00000001" / "node_0.bin")
    got, _, report = mgr.load(state)
    assert report.mode == "repair"
    for a, b in [(got["w"], state["w"]), (got["nested"]["m"], state["nested"]["m"]),
                 (got["b"], state["b"])]:
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
