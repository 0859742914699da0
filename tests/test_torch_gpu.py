"""Card-only tests of the port: the CUDA kernels and the paths they serve.

These tests import neither ``jax`` nor ``repro``, so they run on a machine
that has only PyTorch with CUDA.  Their reference is the port's plain versions
(the GF table product, ``flash_attention_ref``) and its numpy plan layer,
which ``tests/test_torch_{gf,codes,flash}.py`` hold to the JAX package.  Each test
skips itself where no card is present; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import gf, multi_failure
from repro_torch.core.codes import make_code
from repro_torch.core.gf_torch import gf_matmul_table
from repro_torch.dist import collectives, mesh_run, model_run
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.gf_matmul import gf_matmul_batched
from repro_torch.models import backbone
from repro_torch.serve import ServeEngine, make_prefill_step
from repro_torch.train import (
    DataConfig,
    SyntheticStream,
    TrainConfig,
    checkpoint,
    fault_tolerance,
    init_opt_state,
    init_train_state,
    loss_fn,
    make_train_step,
    train_state,
)

pytestmark = pytest.mark.gpu

# tests/test_kernels.py SHAPES plus the ragged widths B = 17 and 333; then
# the bitsliced kernel's edges: R 81 over its 8 row warps with a ragged B,
# R 13 and 81 with K 1 (row warps of uneven size), B below one 32-byte
# group, and B = 2^20 + 5 (many column tiles, a ragged last one)
SHAPES = [
    (1, 1, 128), (2, 3, 128), (3, 6, 256), (4, 12, 384), (9, 18, 512),
    (8, 27, 1024), (16, 64, 2048), (27, 162, 512), (3, 6, 17), (3, 6, 333),
    (81, 162, 4099), (13, 1, 1000), (81, 1, 777), (3, 6, 5), (9, 18, 2**20 + 5),
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


# G x (R, K, B): a ragged batch, and DRC(9,6,3)'s MSR-like (9, 27) NodeEncode
# shape batched G = 9
@pytest.mark.parametrize("g,r,k,b", [(5, 7, 9, 333), (9, 9, 27, 4099)])
def test_kernel_batched_into_unaligned_view(dev, g, r, k, b):
    rng = np.random.default_rng(12 + g)
    m, x = _rand(rng, g, r, k), _rand(rng, g, k, b)
    out = torch.zeros((g + 1, r, b), dtype=torch.uint8, device=dev)
    before = gf_matmul_batched.launches
    gf_matmul_batched(torch.from_numpy(m).to(dev), torch.from_numpy(x).to(dev), out[1:])
    assert gf_matmul_batched.launches == before + 1
    for i in range(g):
        np.testing.assert_array_equal(out[i + 1].cpu().numpy(), gf.gf_matmul(m[i], x[i]))
    assert not bool(out[0].any())


def test_kernel_goes_through_the_custom_op(dev):
    """Every GF launch of the wrappers is the custom op ``repro_torch::gf_matmul``:
    a dispatch mode sees it, the kernel's bytes equal the plain version's and
    the launch counter moves once a call."""
    from repro_torch.check.traced.capture import Capture

    rng = np.random.default_rng(21)
    m = torch.from_numpy(_rand(rng, 9, 9, 27)).to(dev)
    x = torch.from_numpy(_rand(rng, 9, 27, 4099)).to(dev)
    before = gf_matmul_batched.launches
    cap = Capture()
    with cap:
        got = gf_matmul_batched(m, x)
    assert [op.name for op in cap.ops].count("repro_torch.gf_matmul.default") == 1
    assert gf_matmul_batched.launches == before + 1
    for i in range(9):
        assert torch.equal(got[i], gf_matmul_table(m[i], x[i]))
    out = torch.empty_like(got)
    torch.ops.repro_torch.gf_matmul(m, x, out)
    assert torch.equal(out, got) and gf_matmul_batched.launches == before + 1


@pytest.mark.parametrize("fill", [0, 1, 0xFF])
def test_kernel_constant_matrices(dev, fill):
    """All-zero (every nibble skipped), identity-like 1 and 0xFF (every
    nibble with all four bits) coefficients."""
    rng = np.random.default_rng(fill)
    m = np.full((1, 81, 162), fill, dtype=np.uint8)
    x = torch.from_numpy(_rand(rng, 1, 162, 3000)).to(dev)
    mt = torch.from_numpy(m).to(dev)
    before = gf_matmul_batched.launches
    got = gf_matmul_batched(mt, x)
    assert gf_matmul_batched.launches == before + 1
    assert torch.equal(got[0], gf_matmul_table(mt[0], x[0]))


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


@pytest.mark.parametrize("spec", SPMD_CODES, ids=lambda s: "%s%d%d%d" % s)
def test_emulated_mesh_into_garbage_out_on_card(dev, spec):
    code = make_code(*spec)
    rng = np.random.default_rng(4)
    data = _rand(rng, code.k * code.alpha, 4099)
    stacked = torch.stack(code.encode(torch.from_numpy(data).to(dev)))
    for failed in range(code.n):
        sp = collectives.plan_to_spmd(code, code.repair_plan(failed))
        out = torch.from_numpy(_rand(rng, *stacked.shape) | 1).to(dev)
        before = gf_matmul_batched.launches
        collectives.make_spmd_repair(sp)(stacked, out=out)
        assert gf_matmul_batched.launches > before
        row = sp.target_pod * sp.w
        assert torch.equal(out[row], stacked[failed])
        assert not bool(out[:row].any()) and not bool(out[row + 1:].any())


def test_multi_failure_and_code_switch_on_card(dev):
    code = make_code("DRC", 9, 6, 3)
    rng = np.random.default_rng(5)
    data = _rand(rng, code.k * code.alpha, 4096)
    nodes = [gf.gf_matmul(code.node_coeffs(i), data) for i in range(code.n)]
    for failed in ([0, 8], [1, 4, 7], [4]):
        avail = {i: torch.from_numpy(nodes[i]).to(dev) for i in range(code.n) if i not in failed}
        before = gf_matmul_batched.launches
        got, report = multi_failure.multi_failure_repair(code, failed, avail)
        assert gf_matmul_batched.launches > before
        for f in failed:
            assert got[f].device.type == dev.type
            np.testing.assert_array_equal(got[f].cpu().numpy(), nodes[f])
    sw = multi_failure.CodeSwitcher()
    blocks = _rand(rng, 6, 12_289)
    for accesses in (0, 20):
        for _ in range(accesses):
            sw.record_access(3)
        before = gf_matmul_batched.launches
        coded = sw.switch(3, torch.from_numpy(blocks).to(dev))
        assert gf_matmul_batched.launches > before
        target = make_code(*sw.target_code(3))
        kb = np.zeros((6, -(-blocks.shape[1] // target.alpha) * target.alpha), np.uint8)
        kb[:, :blocks.shape[1]] = blocks
        want = [gf.gf_matmul(target.node_coeffs(i), kb.reshape(target.k * target.alpha, -1))
                for i in range(target.n)]
        for c, w in zip(coded, want):
            np.testing.assert_array_equal(c.cpu().numpy(), w)


def test_fault_tolerance_execute_and_rescale_on_card(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    state = {"w": torch.randn((301, 77), generator=g, device=dev),
             "m": torch.randn((64, 33), generator=g, device=dev).bfloat16()}
    ckpt = checkpoint.encode_state(state, family="DRC", n=9, k=6, r=3, device=dev)
    mgr = fault_tolerance.FaultToleranceManager()

    def equal(got):
        return all(torch.equal(got[k].reshape(-1).view(torch.uint8),
                               state[k].reshape(-1).view(torch.uint8)) for k in state)

    for lost, kind in (([2], "repair"), ([0, 5, 8], "decode")):
        before = gf_matmul_batched.launches
        got, report, action = mgr.execute(ckpt, state, lost)
        assert action.kind == kind and gf_matmul_batched.launches > before
        assert got["w"].device.type == dev.type and equal(got)
    before = gf_matmul_batched.launches
    new = mgr.rescale(ckpt, state, n=6, k=4, r=3)
    assert gf_matmul_batched.launches > before and new.payloads[0].device.type == dev.type
    got, report = checkpoint.restore_state(new, state, available={0, 1, 3, 4, 5})
    assert report.mode == "repair" and equal(got)


def test_mesh_executor_on_card_over_gloo(dev, tmp_path):
    """Nine ranks on this card over ``gloo``, payloads staged through the host."""
    build.build_all(["gf_matmul"])  # once, before the ranks load it
    cases = [mesh_run.Case(("DRC", 9, 6, 3), 0, 4096), mesh_run.Case(("RS", 9, 6, 3), 8, 4099),
             mesh_run.Case(("DRC", 9, 5, 3), 8, 4096, stripes=3)]
    for case, row in zip(cases, mesh_run.run(cases, workdir=str(tmp_path), device="cuda")):
        code = make_code(*case.code)
        assert row["equal"] and row["others_zero"], case
        assert all(calls["cuda"] > 0 and calls["ref"] == 0 for calls in row["gf_calls"]), case
        assert row["counters"]["repair.bytes.host_staged"] > 0
        cross = sum(round(code.repair_plan(case.failed, rotation=s).traffic_blocks()[
            "cross_rack_blocks"] * code.alpha) * case.sub for s in range(max(1, case.stripes)))
        assert row["pod_sent_bytes"] == cross == row["counters"]["repair.bytes.cross_rack"]


def test_sharded_prefill_on_card_over_gloo(dev, tmp_path):
    """Two ranks on this card over ``gloo`` (a (data 1, model 2) mesh), the
    dbrx smoke MoE expert-parallel in f32 at a drop-free capacity: rank 0's
    logits equal one process's, the all-gather staged through the host."""
    case = model_run.Case("dbrx-132b", mesh=(1, 2), batch=2, seq=64, smoke=True,
                          param_dtype="float32", capacity_factor=8.0, use_flash=False)
    (row,) = model_run.run([case], workdir=str(tmp_path), device="cuda")
    model = model_run.seeded_model(case, "cuda")
    want = make_prefill_step(model_run.case_config(case), device="cuda", use_flash=False)(
        model, {"tokens": torch.from_numpy(model_run.case_tokens(case))})
    np.testing.assert_allclose(row["logits"], want.cpu().numpy(), atol=1e-4, rtol=0)
    for rank in row["ranks"]:
        assert rank["moe_collectives"]["all_to_all"] == 2 * model_run.case_config(case).n_layers
        assert rank["host_staged_bytes"] > 0 and rank["pairs_dropped"] == 0


def test_sharded_train_step_on_card_over_gloo(dev, tmp_path):
    """One train step of the dbrx smoke MoE in f32 on two ranks of this card
    (a (data 1, model 2) mesh, expert parallel, every token on both ranks, so
    the capacity and the balance loss are one process's): the loss, the
    norm and the updated parameters and moments equal one process's, and
    the backward ran the MoE's reverse ``all_to_all`` pair."""
    case = model_run.Case("dbrx-132b", kind="train", mesh=(1, 2), batch=2, seq=64, smoke=True,
                          param_dtype="float32", capacity_factor=8.0, save_state=True)
    (row,) = model_run.run([case], workdir=str(tmp_path), device="cuda")
    cfg = model_run.case_config(case)
    model, opt, metrics = _one_process_step(case)
    for rank in row["ranks"]:
        np.testing.assert_allclose(rank["loss"], float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norm"], float(metrics["grad_norm"]), rtol=1e-5)
        by_phase = rank["moe_collectives_by_phase"]
        assert by_phase["forward"]["all_to_all"] == by_phase["backward"]["all_to_all"] == \
            2 * cfg.n_layers
    for name, p in model.named_parameters():
        for key, want, atol in (("params", p, 2e-5), ("m", opt["m"][name], 1e-7),
                                ("v", opt["v"][name], 1e-8)):
            np.testing.assert_allclose(row["state"][f"{key}.{name}"],
                                       want.detach().cpu().numpy(), atol=atol, rtol=0)


def test_sharded_decode_on_card_over_gloo(dev, tmp_path):
    """The StarCoder2-3B smoke engine in f32 on two ranks of this card (its
    query heads split over model, its 2 kv heads one a rank): every step's
    logits and the greedy tokens equal one process's engine's."""
    case = model_run.Case("starcoder2-3b", kind="decode", mesh=(1, 2), batch=2, seq=8, new=4,
                          kv_len=16, smoke=True, param_dtype="float32", all_positions=True)
    (row,) = model_run.run([case], workdir=str(tmp_path), device="cuda")
    engine = ServeEngine(model_run.case_config(case), model_run.seeded_model(case, "cuda"),
                         batch=case.batch, kv_len=case.kv_len, device="cuda")
    prompts = torch.from_numpy(model_run.case_tokens(case))
    every = [engine.prefill(prompts[:, t:t + 1]) for t in range(case.seq)]
    tokens = []
    for _ in range(case.new):
        tokens.append(engine.generate(1))
        every.append(engine.last_logits)
    np.testing.assert_allclose(row["logits_all"], torch.stack(every).float().cpu().numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(row["tokens"], torch.cat(tokens, 1).cpu().numpy())


def _one_process_step(case):
    """One process's first train step of ``case`` on this card: (model,
    optimizer state, metrics)."""
    cfg, tcfg = model_run.case_config(case), model_run.train_config(case)
    model = model_run.seeded_model(case, "cuda").requires_grad_(True)
    opt = init_opt_state(model, tcfg.optimizer)
    batch = {k: torch.from_numpy(v).cuda() for k, v in model_run.case_batch(case).items()}
    _, _, metrics = make_train_step(cfg, tcfg)(model, opt, batch, model_run.TRAIN_WARMUP)
    return model, opt, metrics


def test_sharded_tp2d_train_step_on_card_over_gloo(dev, tmp_path):
    """StarCoder2-3B smoke trained under ``tp2d`` in f32 on 8 ranks of this
    card, 2 microbatches: each microbatch's gradients are pinned to their
    parameters' ``_StridedShard`` layouts (ffn and vocab model-major over
    model x data), which torch 2.11's DTensor cannot redistribute into
    (``sharding.redistribute`` reduces and slices instead).  The loss, the
    norm and the updated parameters and moments equal one process's."""
    case = model_run.Case("starcoder2-3b", kind="train", mode="tp2d", batch=4, seq=32,
                          smoke=True, param_dtype="float32", microbatches=2, xent_tile=64,
                          save_state=True)
    (row,) = model_run.run([case], workdir=str(tmp_path), device="cuda")
    model, opt, metrics = _one_process_step(case)
    for rank in row["ranks"]:
        np.testing.assert_allclose(rank["loss"], float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norm"], float(metrics["grad_norm"]), rtol=1e-5)
    for name, p in model.named_parameters():
        for key, want, atol in (("params", p, 2e-5), ("m", opt["m"][name], 1e-7),
                                ("v", opt["v"][name], 1e-8)):
            np.testing.assert_allclose(row["state"][f"{key}.{name}"],
                                       want.detach().cpu().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("arch,use_flash", [("zamba2-1.2b", None), ("whisper-small", False)])
def test_sharded_family_prefill_on_card_over_gloo(dev, tmp_path, arch, use_flash):
    """A family's smoke prefill in f32 on 8 ranks of this card under ``tp``:
    zamba2's Mamba2 on each rank's heads from the gathered fused product and
    its shared block through the flash kernel (head dim 32); whisper's
    encoder, decoder and cross-attention on the ranks' heads (head dim 16,
    which the kernel does not take: the chunked path).  Every position's
    logits equal one process's."""
    case = model_run.Case(arch, batch=4, seq=64, smoke=True, param_dtype="float32",
                          all_positions=True, use_flash=use_flash)
    (row,) = model_run.run([case], workdir=str(tmp_path), device="cuda")
    cfg = model_run.case_config(case)
    inputs = {k: torch.from_numpy(v).cuda() for k, v in model_run.case_inputs(case).items()}
    with torch.no_grad():
        want, _ = backbone.forward(model_run.seeded_model(case, "cuda"), cfg, inputs,
                                   use_flash=use_flash)
    np.testing.assert_allclose(row["logits_all"], want.float().cpu().numpy(), atol=1e-4, rtol=0)
    launches = cfg.n_layers // cfg.shared_attn_every if use_flash is None else 0
    assert all(rank["flash_launches"] == launches for rank in row["ranks"])


def test_sharded_pod_prefill_on_card_over_gloo(dev, tmp_path):
    """zamba2 smoke in f32 on 8 ranks of this card as a (pod 2, data 2, model
    2) mesh under the multi-pod ``tp`` rules (the batch over pod x data),
    its shared block through the flash kernel: every position's logits
    equal one process's, the kernel launched on every rank."""
    case = model_run.Case("zamba2-1.2b", mesh=(2, 2, 2), batch=4, seq=64, smoke=True,
                          param_dtype="float32", all_positions=True)
    (row,) = model_run.run([case], workdir=str(tmp_path), device="cuda")
    cfg = model_run.case_config(case)
    inputs = {k: torch.from_numpy(v).cuda() for k, v in model_run.case_inputs(case).items()}
    with torch.no_grad():
        want, _ = backbone.forward(model_run.seeded_model(case, "cuda"), cfg, inputs)
    np.testing.assert_allclose(row["logits_all"], want.float().cpu().numpy(), atol=1e-4, rtol=0)
    assert all(rank["flash_launches"] == cfg.n_layers // cfg.shared_attn_every
               for rank in row["ranks"])


def test_sharded_checkpoint_round_trip_on_card(dev, tmp_path):
    """A StarCoder2-3B smoke train state in f32 over a (2, 2, 2) mesh of 8
    ranks of this card, under fsdp, after one step: the sharded save (rank 0
    gathers, encodes through the GF kernel, writes) equals a one-process
    encode of the gathered state, node 2 is lost, the load repairs and lays
    every rank's blocks out bit-equal to the saved ones, and the resumed
    step's loss equals the uninterrupted one's."""
    case = model_run.Case("starcoder2-3b", kind="train", mode="fsdp", mesh=(2, 2, 2), batch=4,
                          seq=64, smoke=True, param_dtype="float32", checkpoint=True)
    (row,) = model_run.run([case], workdir=str(tmp_path), device="cuda")
    ck = [rank["checkpoint"] for rank in row["ranks"]]
    assert ck[0]["crcs"] == ck[0]["crcs_one_process"]
    assert all(c["restored_equal"] and c["mode"] == "repair" and c["repaired_nodes"] == [2]
               for c in ck)
    assert all(c["resumed"]["loss"] == c["uninterrupted"]["loss"] for c in ck)
    assert ck[0]["gf_launches"] > 0


def test_flash_custom_op_fake_and_real(dev):
    """The flash kernel's custom op: on fake card tensors its fake kernel
    gives the output's spec and the FLOP counter ``chip_smoke.py``'s
    ``flash_flops``, with no launch counted; on real ones it equals the
    launch it wraps bit for bit."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa

    before = fa.flash_attention.launches
    with FakeTensorMode():
        q = torch.empty(2, 300, 8, 128, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 300, 2, 128, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fc:
            out = fa.flash_attention(q, k, k, causal=True)
        assert tuple(out.shape) == (2, 300, 8, 128) and out.dtype == torch.bfloat16
    pairs = sum(min(i + 1, 300) for i in range(300))
    assert fc.get_total_flops() == 4 * 2 * 8 * 128 * pairs
    assert fa.flash_attention.launches == before
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 300, 8, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, 300, 2, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(2, 300, 2, 128, generator=gen, device="cuda").bfloat16()
    got = torch.ops.repro_torch.flash_attention(q, k, v, True)
    want = fa.launch(fa._launch_fn(), q, k, v, True)
    assert torch.equal(got, want)
    assert fa.flash_attention.launches == before


# tests/test_flash_attention.py SWEEP: b, sq, sk, h, kvh, d, causal; plus ragged
# lengths, and the bf16 kernel's pipeline cases: 16 kv tiles wrap its 2-stage
# K/V ring 8 times; Sq < Sk, causal, ragged on both axes; a causal 192-row
# query whose second 128-row tile has a consumer warpgroup with no valid row;
# and more work items than SMs for the persistent CTAs, with the ragged
# items (a warpgroup with no valid row) first, one or several per CTA
FLASH_SWEEP = [
    (1, 256, 256, 2, 2, 64, True), (2, 512, 512, 1, 1, 128, True),
    (1, 256, 512, 2, 2, 64, False), (1, 256, 256, 4, 2, 64, True),
    (2, 256, 256, 8, 2, 32, True), (1, 128, 384, 3, 1, 64, False),
    (1, 100, 77, 4, 2, 128, True), (2, 77, 130, 6, 3, 32, False),
    (1, 2048, 2048, 4, 1, 128, True), (1, 2048, 2048, 4, 1, 128, False),
    (2, 130, 300, 4, 2, 64, True), (1, 192, 192, 4, 2, 32, True),
    (2, 1050, 1050, 96, 8, 64, True), (4, 50, 300, 80, 4, 64, False),
]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-5), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", FLASH_SWEEP)
def test_flash_kernel_matches_plain_and_launches(dev, b, sq, sk, h, kvh, d, causal, dtype, atol):
    g = torch.Generator(device=dev)
    g.manual_seed(b * 100 + sq + h)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, kvh, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, kvh, d), generator=g, device=dev).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, sq, h, d)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-5), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_reads_views_of_fused_qkv(dev, d, dtype, atol):
    """q, k and v as strided views of one (B, S, H + 2 kvH, D) tensor: the
    kernel (its TMA tensor maps, on the bf16 path) reads them through their
    byte strides and gives what it gives on contiguous copies."""
    b, s, h, kvh = 2, 300, 6, 2
    g = torch.Generator(device=dev)
    g.manual_seed(d)
    fused = torch.randn((b, s, h + 2 * kvh, d), generator=g, device=dev).to(dtype)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kvh], fused[:, :, h + kvh:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = flash_attention(q, k, v, causal=True)
    dense = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    want = flash_attention_ref(q, k, v, causal=True)
    assert float((got.float() - want.float()).abs().max()) <= atol


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 64, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros((1, 64, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 64, 2, 64), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q.transpose(1, 3).contiguous().transpose(1, 3), q)


def test_serve_engine_on_card(dev):
    # head dim 32: the kernel takes 32, 64 and 128 (the smoke config has 16)
    cfg = dataclasses.replace(configs.get_smoke("starcoder2_3b"), d_model=192)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    model = backbone.init_model(cfg, generator=g, device="cuda")
    # 200 and 1500 are no multiple of 256 nor of the kernel's 64-row tile:
    # every length takes the kernel, once per layer
    for s in (256, 200, 1500):
        toks = torch.randint(0, cfg.vocab, (2, s), generator=g, device=dev)
        before = flash_attention.launches
        logits = make_prefill_step(cfg, device="cuda")(model, {"tokens": toks})
        assert flash_attention.launches == before + cfg.n_layers
        plain = make_prefill_step(cfg, device="cuda", use_flash=False)(model, {"tokens": toks})
        assert float((logits.float() - plain.float()).abs().max()) <= \
            0.05 * float(plain.float().abs().max())
    eng = ServeEngine(cfg, model, batch=2, kv_len=24, device="cuda")
    eng.prefill(toks[:, :8])
    out = eng.generate(4)
    assert out.shape == (2, 4) and out.device.type == "cuda"
    assert int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab and eng.position == 12



@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_kernel_refuses_autograd(dev, which):
    """The kernel has no backward: where autograd would record the call it
    raises, naming the chunked path, rather than return an output with no
    gradient edge.  Under ``no_grad`` the same tensors launch it."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((1, 128, 2, 64), generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    {"q": q, "k": k, "v": v}[which].requires_grad_(True)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="chunked"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1 and not out.requires_grad
    torch.testing.assert_close(out, flash_attention_ref(q.detach(), k.detach(), v.detach()),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_on_card_matches_cpu(dev, microbatches):
    """One f32 train step of the StarCoder2-3B smoke config, from the same
    state and batch, on the card and on the CPU: parameters within atol 2e-5
    (``tests/test_train.py``'s step tolerance), the loss within rtol 1e-5.
    The step takes the chunked attention, never the flash kernel."""
    cfg = dataclasses.replace(configs.get_smoke("starcoder2_3b"), param_dtype="float32",
                              remat="full")
    tcfg = TrainConfig(microbatches=microbatches, attn_chunk=16, xent_tile=128)
    cpu_model, cpu_opt = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                          device="cpu")
    model, opt = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, tcfg,
                                  device="cuda")
    checkpoint.copy_state_(train_state(model, opt), train_state(cpu_model, cpu_opt))
    data = DataConfig(seed=4, batch=4, seq=64)
    before = flash_attention.launches
    _, _, m_gpu = make_train_step(cfg, tcfg)(
        model, opt, SyntheticStream(cfg, data, device="cuda").batch_at(5), 5)
    _, _, m_cpu = make_train_step(cfg, tcfg)(
        cpu_model, cpu_opt, SyntheticStream(cfg, data, device="cpu").batch_at(5), 5)
    assert flash_attention.launches == before
    np.testing.assert_allclose(float(m_gpu["loss"]), float(m_cpu["loss"]), rtol=1e-5)
    for (name, p), (_, want) in zip(model.named_parameters(), cpu_model.named_parameters()):
        assert p.is_cuda
        np.testing.assert_allclose(p.detach().cpu().numpy(), want.detach().numpy(), atol=2e-5,
                                   err_msg=name)


def test_bf16_train_step_on_card_has_a_gradient_for_every_parameter(dev):
    """The smoke config widened to head dim 32 in bf16 under each remat policy:
    every parameter gets a finite, nonzero gradient, and the losses agree."""
    base = dataclasses.replace(configs.get_smoke("starcoder2_3b"), d_model=192)
    batch = SyntheticStream(base, DataConfig(batch=2, seq=256), device="cuda").batch_at(0)
    losses = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        model, opt = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                                      TrainConfig(attn_chunk=64), device="cuda")
        norms = {}
        hooks = [p.register_hook(lambda g, name=name: norms.__setitem__(
            name, float(torch.linalg.vector_norm(g.float())))) for name, p in model.named_parameters()]
        _, _, m = make_train_step(cfg, TrainConfig(attn_chunk=64))(model, opt, batch, 0)
        for h in hooks:
            h.remove()
        assert set(norms) == {name for name, _ in model.named_parameters()}
        assert all(np.isfinite(v) and v > 0 for v in norms.values()), norms
        losses[remat] = float(m["loss"])
    assert losses["full"] == pytest.approx(losses["none"], rel=1e-3)
    assert losses["dots"] == pytest.approx(losses["none"], rel=1e-3)


# one smoke config per family, widened to head dim 64 (the kernel takes 32, 64
# and 128; the smoke configs have 16 or 32): d_model = 64 * heads
FAMILY_SMOKES = ["dbrx_132b", "zamba2_1p2b", "xlstm_125m", "internvl2_1b", "whisper_small"]


def _family_inputs(cfg, g, b, s):
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")}
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.randn((b, cfg.vision_tokens, cfg.d_model), generator=g,
                                          device="cuda").bfloat16()
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g,
                                      device="cuda").bfloat16()
    return batch


@pytest.mark.parametrize("arch", FAMILY_SMOKES)
def test_family_prefill_and_engine_on_card(dev, arch):
    base = configs.get_smoke(arch)
    cfg = dataclasses.replace(base, d_model=64 * base.n_heads)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, encoder_seq=300)  # no multiple of the 64-row tile
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    model = backbone.init_model(cfg, generator=g, device="cuda")
    want = cfg.n_layers  # flash launches per forward
    if cfg.family == "ssm":
        want = 0
    elif cfg.family == "hybrid":  # the shared block, once per whole segment
        want = cfg.n_layers // cfg.shared_attn_every
    elif cfg.family == "audio":  # encoder self-attention, decoder self and cross
        want = cfg.encoder_layers + 2 * cfg.n_layers
    batch = _family_inputs(cfg, g, 2, 128)
    before = flash_attention.launches
    logits = make_prefill_step(cfg, device="cuda")(model, batch)
    assert flash_attention.launches == before + want
    plain = make_prefill_step(cfg, device="cuda", use_flash=False)(model, batch)
    assert bool(torch.isfinite(logits.float()).all())
    assert float((logits.float() - plain.float()).abs().max()) <= \
        0.05 * float(plain.float().abs().max())
    eng = ServeEngine(cfg, model, batch=2, kv_len=24, device="cuda")
    if cfg.family == "audio":
        with torch.no_grad():
            eng.state["enc"] = backbone._run_encoder(model, cfg, batch["frames"])
    last = eng.prefill(batch["tokens"][:, :8])
    out = eng.generate(4)
    assert out.shape == (2, 4) and out.device.type == "cuda" and eng.position == 12
    assert int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab
    fwd_cfg = cfg
    if cfg.moe:  # the forward's capacity counts every token: make it drop none
        fwd_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    full_batch = {"tokens": batch["tokens"][:, :8]}
    if cfg.family == "audio":
        full_batch["frames"] = batch["frames"]
    full = make_prefill_step(fwd_cfg, device="cuda")(model, full_batch)
    rtol = 0.10 if cfg.family == "ssm" else 0.05  # chip_smoke.py's ENGINE_RTOL, and why
    assert float((last - full.float()).abs().max()) <= rtol * float(full.float().abs().max())


def test_moe_expert_products_accumulate_in_f32_on_card(dev):
    from repro_torch.models import mlp

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    a = torch.randn((4, 64, 256), generator=g, device="cuda").bfloat16()
    b = torch.randn((4, 256, 128), generator=g, device="cuda").bfloat16()
    got = mlp._bmm_f32(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.bmm(a.float(), b.float()), atol=1e-3, rtol=1e-4)


# training, every family: grok too (its GeLU experts never read moe.gate)
TRAIN_SMOKES = FAMILY_SMOKES + ["grok_1_314b"]
# the card's bf16 loss against the CPU's from the same state and batch: both
# round activations to bf16 after every product but sum in other orders
# (tensor-core tiles, the MoE combine's atomics), 2^-7 relative a rounding;
# the loss, a mean over 1,024 positions, moves far less than one logit
TRAIN_LOSS_RTOL = 1e-2
# a bf16 gradient through the expert products, the card's path against the
# upcast one: four bf16 roundings of 2^-8 each (tests/test_torch_family_train.py)
BF16_GRAD_RTOL = 2.0**-5


def _train_smoke(arch):
    base = configs.get_smoke(arch)
    return dataclasses.replace(base, d_model=64 * base.n_heads, remat="full")


def _unused(cfg, name):
    return cfg.moe is not None and cfg.mlp_act != "swiglu" and name.endswith("moe.gate")


@pytest.mark.parametrize("arch", TRAIN_SMOKES)
def test_family_bf16_train_step_on_card(dev, arch):
    """One bf16 train step (remat ``full``, two mLSTM chunks for xlstm, where
    the decay overflows f32 above the diagonal): a finite gradient for every
    parameter, nonzero but for grok's unused ``moe.gate`` (exactly zero: the
    step leaves it at AdamW's decay alone, which at this learning rate rounds
    back to the same bf16 values), no flash launch, and the loss within
    ``TRAIN_LOSS_RTOL`` of the CPU's from the same state and batch."""
    cfg = _train_smoke(arch)
    tcfg = TrainConfig(attn_chunk=64)
    model, opt = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, tcfg,
                                  device="cuda")
    cpu_model, cpu_opt = init_train_state(torch.Generator().manual_seed(1), cfg, tcfg,
                                          device="cpu")
    checkpoint.copy_state_(train_state(cpu_model, cpu_opt), train_state(model, opt))
    batch = SyntheticStream(cfg, DataConfig(batch=2, seq=512), device="cuda").batch_at(0)
    with torch.no_grad():
        want, _ = loss_fn(cpu_model, cfg, tcfg, {k: v.cpu() for k, v in batch.items()})
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items() if _unused(cfg, n)}
    norms = {}
    hooks = [p.register_hook(lambda g, name=name: norms.__setitem__(
        name, float(torch.linalg.vector_norm(g.float())))) for name, p in named.items()]
    launches = flash_attention.launches
    try:
        _, _, m = make_train_step(cfg, tcfg)(model, opt, batch, 0)
    finally:
        for h in hooks:
            h.remove()
    assert flash_attention.launches == launches
    assert set(norms) == {n for n in named if not _unused(cfg, n)}
    assert all(np.isfinite(v) and v > 0 for v in norms.values()), norms
    assert (len(before) > 0) == (arch == "grok_1_314b")
    wd = tcfg.optimizer.weight_decay
    for name, was in before.items():  # no gradient: weight decay alone, in f32, rounded
        assert float(opt["m"][name].abs().max()) == 0.0
        decayed = (was.float() - m["lr"] * (wd * was.float())).to(was.dtype)
        assert torch.equal(named[name].detach(), decayed)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert float(m["loss"]) == pytest.approx(float(want), rel=TRAIN_LOSS_RTOL)


@pytest.mark.parametrize("arch", ["dbrx_132b", "grok_1_314b"])
def test_moe_expert_products_gradient_on_card_matches_the_upcast_path(dev, arch, monkeypatch):
    """The card's expert products (``_BmmF32``: bf16 tensor cores, f32 sums,
    a backward of f32 products) against the CPU build's form (the inputs
    upcast, autograd's own backward) on the same card, model and batch:
    every gradient within ``BF16_GRAD_RTOL`` of its largest entry."""
    from repro_torch.models import mlp

    cfg = dataclasses.replace(_train_smoke(arch), remat="none")
    tcfg = TrainConfig(attn_chunk=64)
    model, _ = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, tcfg,
                                device="cuda")
    batch = SyntheticStream(cfg, DataConfig(batch=2, seq=256), device="cuda").batch_at(0)
    params = list(model.parameters())

    def grads():
        loss, _ = loss_fn(model, cfg, tcfg, batch)
        return loss, torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)

    card_loss, card = grads()
    monkeypatch.setattr(mlp, "_bmm_f32", lambda a, b: torch.bmm(a.float(), b.float()))
    up_loss, upcast = grads()
    assert float(card_loss) == pytest.approx(float(up_loss), rel=1e-3)
    for (name, _), a, b in zip(model.named_parameters(), card, upcast):
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=BF16_GRAD_RTOL * max(scale, 1e-30), msg=name)


# ------------------------------------------------ the verification layer
def test_kernel_geometry_queries_equal_the_checker_s_models(dev):
    """At every shape of ``repro_torch.check``'s ``cuda-kernel`` sweep, the
    launch the built kernels report (``..._geometry_query``) is the Python
    model the checker sweeps, at this card's SM count and blocks per SM."""
    from repro_torch.check.lowered import cuda as ccuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf_matmul as gk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, shape in ccuda.gf_sweep_shapes():
        got = gk.geometry_query(build.load("gf_matmul"), *shape)
        assert got["sms"] == sms, label
        assert got == gk.gf_matmul_geometry(*shape, sms=sms, per_sm=got["per_sm"]).query_fields()
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for label, dtype, (b, sq, sk, h, kvh, d, causal) in ccuda.flash_sweep_shapes():
        got = fa.work_geometry_query(build.load("flash_attention"), b, sq, sk, h, kvh, d,
                                     dtypes[dtype])
        want = fa.flash_attention_work_geometry(b, sq, sk, h, kvh, d, dtypes[dtype], sms,
                                                causal=causal)
        assert got == want.query_fields(), label
    with pytest.raises(RuntimeError):  # the f32 grid's y limit, refused as the launch is
        fa.work_geometry_query(build.load("flash_attention"), 300, 8, 8, 256, 1, 64,
                               torch.float32)


@pytest.mark.parametrize("shape,offset", [((9, 5, 7, 333), 4097), ((1, 6, 12, 65_541), 4096),
                                          ((1, 200, 8, 5_008), 4096), ((9, 5, 7, 336), 4096)])
def test_gf_guard_band_launch(dev, shape, offset):
    """The kernel writes its (G, R, B) view of a 0xA5-filled buffer and not
    one byte around it, on the aligned and the unaligned path."""
    from repro_torch.kernels import gf_matmul as gk

    g, r, k, b = shape
    rng = np.random.default_rng(g * r * k + b)
    m = torch.from_numpy(_rand(rng, g, r, k)).to(dev)
    x = torch.from_numpy(_rand(rng, g, k, b)).to(dev)
    buf = torch.full((offset + g * r * b + 4096,), 0xA5, dtype=torch.uint8, device=dev)
    out = buf[offset:offset + g * r * b].view(g, r, b)
    gk.launch(gk._launch_fn(), m, x, out)
    torch.cuda.synchronize()
    assert bool((buf[:offset] == 0xA5).all()) and bool((buf[offset + g * r * b:] == 0xA5).all())
    for i in range(g):
        assert torch.equal(out[i], gf_matmul_table(m[i], x[i]))


@pytest.mark.parametrize("shape,dtype,atol", [
    ((2, 333, 517, 8, 2, 64, True), torch.bfloat16, 3e-2),
    ((1, 100, 77, 4, 2, 128, True), torch.bfloat16, 3e-2),
    ((2, 77, 130, 6, 3, 32, False), torch.float32, 3e-5)])
def test_flash_guard_band_launch(dev, shape, dtype, atol):
    """The kernel writes the rows of an output with padded strides (passed to
    ``flash_attention_launch`` as they are) and leaves the NaN gaps alone."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, sk, h, kvh, d, causal = shape
    g = torch.Generator(device=dev)
    g.manual_seed(sq + h)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, kvh, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, kvh, d), generator=g, device=dev).to(dtype)
    full = torch.full((b, sq + 3, h + 1, d + 8), float("nan"), dtype=dtype, device=dev)
    out = full[:, :sq, :h, :d]
    before = fa.flash_attention.launches
    fa.launch(fa._launch_fn(), q, k, v, causal, out=out)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before
    gaps = torch.ones(full.shape, dtype=torch.bool, device=dev)
    gaps[:, :sq, :h, :d] = False
    assert bool(torch.isnan(full[gaps]).all())
    want = flash_attention_ref(q, k, v, causal=causal)
    assert float((out.float() - want.float()).abs().max()) <= atol
