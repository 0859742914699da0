"""The port's training entry points for every model family, on the CPU: the
synthetic stream's side inputs against the reference's, an erasure-coded
checkpoint of each family's training state restored through the layered
repair byte for byte, and the launcher's ``--arch`` for every family with
``--resume`` through a lost shard."""
import os
import re
import shutil

import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import train as rtrain

from repro_torch import configs as tconfigs
from repro_torch.core.codes import make_code
from repro_torch.launch import train as launch_train
from repro_torch.train import (
    AdamWConfig,
    DataConfig,
    ScheduleConfig,
    SyntheticStream,
    TrainConfig,
    init_train_state,
    make_train_step,
    train_state,
)
from repro_torch.train.checkpoint import (
    CheckpointManager,
    copy_state_,
    encode_state,
    restore_state,
    state_to_bytes,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ["dbrx-132b", "grok-1-314b", "xlstm-125m", "zamba2-1.2b", "internvl2-1b",
            "whisper-small"]


@pytest.mark.parametrize("arch,seed,step", [("internvl2_1b", 0, 0), ("whisper_small", 5, 9),
                                            ("internvl2_1b", 3, 4096)])
def test_synthetic_stream_side_inputs_equal_reference(arch, seed, step):
    """vlm: ``vis_embeds`` and the labels padded with -1 over the visual
    positions; audio: ``frames``.  Every bf16 side input bit-equal."""
    data = dict(seed=seed, batch=3, seq=40)
    want = rtrain.SyntheticStream(rconfigs.get_smoke(arch), rtrain.DataConfig(**data)).batch_at(step)
    got = SyntheticStream(tconfigs.get_smoke(arch), DataConfig(**data), device="cpu").batch_at(step)
    side = "vis_embeds" if "internvl2" in arch else "frames"
    assert got.keys() == want.keys() == {"tokens", "labels", side}
    cfg = tconfigs.get_smoke(arch)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got[side].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[side].view(torch.int16).numpy(),
                                  np.asarray(want[side]).view(np.int16))
    if side == "vis_embeds":
        assert got[side].shape == (3, cfg.vision_tokens, cfg.d_model)
        assert got["labels"].shape == (3, cfg.vision_tokens + 40)
        assert bool((got["labels"][:, :cfg.vision_tokens] == -1).all())
    else:
        assert got[side].shape == (3, cfg.encoder_seq, cfg.d_model)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_training_state_checkpoint_restores_byte_equal(arch):
    """One train step (with the full config's AdamW state dtype: bf16 moments
    for dbrx and grok), then the state encoded with DRC(9,6,3); node 0 lost
    and restored through the layered repair, byte for byte, with the plan's
    cross-rack blocks; then copied back in place."""
    cfg = tconfigs.get_smoke(arch)
    state_dtype = tconfigs.get_config(arch).opt_state_dtype
    tcfg = TrainConfig(optimizer=AdamWConfig(state_dtype=state_dtype), attn_chunk=16)
    model, opt = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg, device="cpu")
    batch = SyntheticStream(cfg, DataConfig(batch=2, seq=32), device="cpu").batch_at(0)
    make_train_step(cfg, tcfg)(model, opt, batch, 0)
    live = train_state(model, opt)
    want = state_to_bytes(live)[0]
    dtypes = {t.dtype for t in opt["m"].values()}
    assert dtypes == {torch.bfloat16 if state_dtype == "bfloat16" else torch.float32}
    ckpt = encode_state(live, family="DRC", n=9, k=6, r=3, step=1, device="cpu")
    got, report = restore_state(ckpt, live, available=set(range(1, 9)))
    plan = make_code("DRC", 9, 6, 3).repair_plan(0)
    assert report.mode == "repair"
    assert report.cross_rack_blocks == plan.traffic_blocks()["cross_rack_blocks"]
    assert torch.equal(state_to_bytes(got)[0], want)
    assert got["params"].keys() == live["params"].keys()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    copy_state_(live, got)
    assert torch.equal(state_to_bytes(live)[0], want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_runs_every_family(arch, capsys):
    """``--arch`` of every family at the smoke size: a loss logged for every
    step, each finite, and the exit code the launcher's success test on them.
    (Over fresh batches at this size the loss moves less than the batches
    differ; ``test_family_loss_falls_on_a_repeated_batch`` shows it learns.)"""
    rc = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                            "--seq", "32", "--steps", "6", "--log-every", "1"])
    losses = [float(x) for x in re.findall(r"loss=([0-9.naninf]+)", capsys.readouterr().out)]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert rc == (0 if launch_train.training_ok(losses) else 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_falls_on_a_repeated_batch(arch):
    """12 steps of ``make_train_step`` on one batch of the stream, at the
    launcher's AdamW state dtype: the loss falls well below where it began."""
    cfg = tconfigs.get_smoke(arch)
    tcfg = TrainConfig(optimizer=AdamWConfig(state_dtype=cfg.opt_state_dtype),
                       schedule=ScheduleConfig(kind="constant", peak_lr=1e-3, warmup_steps=2),
                       attn_chunk=16)
    model, opt = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg, device="cpu")
    batch = SyntheticStream(cfg, DataConfig(batch=4, seq=64), device="cpu").batch_at(0)
    step = make_train_step(cfg, tcfg)
    losses = [step(model, opt, batch, i)[2]["loss"].item() for i in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5


@pytest.mark.parametrize("arch", ["dbrx-132b", "whisper-small"])
def test_launcher_resumes_a_family_through_a_lost_shard(tmp_path, capsys, arch):
    """8 steps with checkpoints at 3, 6 and 8; step 8's checkpoint is deleted
    and step 6's ``node_2.bin`` lost: ``--resume`` restores step 6 through
    the layered repair and replays steps 6 and 7 with the first run's
    losses."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--lr", "1e-3", "--steps", "8", "--log-every", "1", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path)]
    launch_train.main(args)
    first = dict(re.findall(r"step=(\d+) loss=([0-9.]+)", capsys.readouterr().out))
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.steps() == [3, 6, 8]
    shutil.rmtree(mgr._stepdir(8))
    os.remove(os.path.join(mgr._stepdir(6), "node_2.bin"))
    launch_train.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6 (restore mode=repair)" in out
    replay = dict(re.findall(r"step=(\d+) loss=([0-9.]+)", out))
    assert set(replay) == {"6", "7"}
    assert replay == {k: first[k] for k in replay}
