"""Port parity: erasure-coded checkpoints.

The same f32 + bf16 + int32 state goes through both packages' encode: the
payloads and their CRCs must be identical, each package's
``CheckpointManager`` must restore the other's directory with one node file
deleted, and ``checkpoint_from_arrays`` must restore a reference
``EncodedCheckpoint``.  Exact equality throughout.
"""
import os
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as rck

from repro_torch.train import checkpoint as tck

SPECS = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3)]
IDS = lambda s: "%s%d%d%d" % s  # noqa: E731


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((37, 53)).astype(np.float32),
        "b": np.arange(11, dtype=np.int32),
        "nested": {"m": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
                   "a": rng.standard_normal((3,)).astype(np.float32)},
    }


def _jax_state(arrays):
    return {k: _jax_state(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in arrays.items()}


def _torch_leaf(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _torch_state(arrays):
    return {k: _torch_state(v) if isinstance(v, dict) else _torch_leaf(v)
            for k, v in arrays.items()}


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(leaf).reshape(-1).view(np.uint8)


def _assert_state_equal(got, arrays):
    assert got.keys() == arrays.keys()
    for key, want in arrays.items():
        if isinstance(want, dict):
            _assert_state_equal(got[key], want)
        else:
            assert tuple(got[key].shape) == want.shape
            np.testing.assert_array_equal(_bits(got[key]), want.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_encode_state_payloads_and_crcs_identical(spec):
    arrays = _arrays(0)
    fam, n, k, r = spec
    ref = rck.encode_state(_jax_state(arrays), family=fam, n=n, k=k, r=r)
    port = tck.encode_state(_torch_state(arrays), family=fam, n=n, k=k, r=r, device="cpu")
    assert port.meta == ref.meta and port.total_bytes == ref.total_bytes
    for i in range(n):
        got = port.payloads[i].numpy()
        np.testing.assert_array_equal(got, ref.payloads[i])
        assert zlib.crc32(got.tobytes()) == zlib.crc32(ref.payloads[i].tobytes())


def test_state_bytes_match_reference():
    arrays = _arrays(1)
    buf, meta = tck.state_to_bytes(_torch_state(arrays))
    rbuf, rmeta = rck.state_to_bytes(_jax_state(arrays))
    assert meta == rmeta
    assert buf.numpy().tobytes() == rbuf
    _assert_state_equal(tck.bytes_to_state(buf, meta, _torch_state(arrays)), arrays)


@pytest.mark.parametrize("failed", [0, 4, 8])
def test_restore_single_failure_layered_repair(failed):
    arrays = _arrays(2)
    state = _torch_state(arrays)
    ckpt = tck.encode_state(state, family="DRC", n=9, k=6, r=3, device="cpu")
    got, report = tck.restore_state(ckpt, state, available=set(range(9)) - {failed})
    _assert_state_equal(got, arrays)
    if failed < 6:
        assert report.mode == "repair"
        assert report.cross_rack_blocks == pytest.approx(2.0)  # Eq. (3)
    payload, traffic = tck.repair_node(ckpt, failed)
    assert torch.equal(payload, ckpt.payloads[failed])
    assert traffic["cross_rack_blocks"] == pytest.approx(2.0)


def test_restore_multi_failure_and_unrecoverable():
    arrays = _arrays(3)
    state = _torch_state(arrays)
    ckpt = tck.encode_state(state, family="DRC", n=9, k=6, r=3, device="cpu")
    got, report = tck.restore_state(ckpt, state, available={0, 2, 4, 5, 7, 8})
    assert report.mode == "decode"
    _assert_state_equal(got, arrays)
    with pytest.raises(ValueError, match="unrecoverable"):
        tck.restore_state(ckpt, state, available={0, 1, 2, 3, 4})


@pytest.mark.parametrize("deleted", [1, 7])
def test_managers_restore_each_others_directories(tmp_path, deleted):
    arrays = _arrays(4)
    jstate, tstate = _jax_state(arrays), _torch_state(arrays)
    tck.CheckpointManager(str(tmp_path / "port"), device="cpu").save(3, tstate)
    rck.CheckpointManager(str(tmp_path / "ref")).save(3, jstate)
    for side in ("port", "ref"):
        os.remove(tmp_path / side / "step_00000003" / f"node_{deleted}.bin")
    for name in [f"node_{i}.bin" for i in range(9) if i != deleted] + ["meta.json"]:
        assert (tmp_path / "port" / "step_00000003" / name).read_bytes() == \
            (tmp_path / "ref" / "step_00000003" / name).read_bytes(), name
    got, step, report = rck.CheckpointManager(str(tmp_path / "port")).load(jstate)
    assert step == 3 and report.mode == ("repair" if deleted < 6 else "direct")
    _assert_state_equal(got, arrays)
    got, step, report = tck.CheckpointManager(str(tmp_path / "ref"), device="cpu").load(tstate)
    assert step == 3 and report.mode == ("repair" if deleted < 6 else "direct")
    _assert_state_equal(got, arrays)


def test_corrupt_node_file_takes_repair_path(tmp_path):
    arrays = _arrays(5)
    state = _torch_state(arrays)
    mgr = tck.CheckpointManager(str(tmp_path), device="cpu", keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.steps() == [2, 3]
    path = tmp_path / "step_00000003" / "node_2.bin"
    raw = bytearray(path.read_bytes())
    raw[0] ^= 0xFF
    path.write_bytes(bytes(raw))
    got, step, report = mgr.load(state)
    assert step == 3 and report.mode == "repair" and report.repaired_nodes == [2]
    _assert_state_equal(got, arrays)


def test_checkpoint_from_arrays_restores_reference_checkpoint():
    arrays = _arrays(6)
    ref = rck.encode_state(_jax_state(arrays), family="DRC", n=9, k=5, r=3, step=9)
    ckpt = tck.checkpoint_from_arrays(ref.code_spec, ref.payloads, ref.total_bytes,
                                      ref.meta, ref.step, device="cpu")
    assert ckpt.step == 9 and ckpt.code_spec == ("DRC", 9, 5, 3)
    got, report = tck.restore_state(ckpt, _torch_state(arrays), available=set(range(9)) - {0})
    assert report.mode == "repair"
    _assert_state_equal(got, arrays)
    payload, _ = tck.repair_node(ckpt, 0)
    np.testing.assert_array_equal(payload.numpy(), ref.payloads[0])


def test_encode_writes_parity_in_place():
    code = tck.make_code("DRC", 9, 6, 3)
    step = tck.make_encode_step(code, 256, "cpu")
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=(code.k * code.alpha, 256), dtype=np.uint8)
    stripe = torch.zeros((code.n * code.alpha, 256), dtype=torch.uint8)
    stripe[: data.shape[0]] = torch.from_numpy(data)
    ptr = stripe.data_ptr()
    out = step(stripe)
    assert out.data_ptr() == ptr
    np.testing.assert_array_equal(out.numpy(), np.concatenate(code.encode(torch.from_numpy(data))))
