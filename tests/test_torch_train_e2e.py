"""The port's training entry points end to end, on the CPU: the launcher with
erasure-coded checkpoints and ``--resume`` (through the layered repair when a
shard is lost), and the two demos."""
import math
import os
import re

import pytest
import torch

from repro_torch import configs
from repro_torch.core.codes import make_code
from repro_torch.examples import elastic_recovery, train_e2e
from repro_torch.launch import train as launch_train
from repro_torch.models.weights import named_arrays
from repro_torch.train import (
    DataConfig,
    SyntheticStream,
    TrainConfig,
    init_train_state,
    loss_fn,
    train_state,
)
from repro_torch.train.checkpoint import CheckpointManager
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LAUNCH = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "64",
          "--lr", "1e-2", "--log-every", "100"]


def _first_loss(out: str) -> float:
    return float(re.search(r"done: first=([0-9.]+)", out).group(1))


@pytest.mark.parametrize("lose_shard", [False, True], ids=["direct", "repair"])
def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys, lose_shard):
    args = LAUNCH + ["--ckpt-dir", str(tmp_path)]
    assert launch_train.main(args + ["--steps", "16", "--ckpt-every", "8"]) == 0
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.steps() == [8, 16]
    if lose_shard:
        os.remove(os.path.join(mgr._stepdir(16), "node_2.bin"))
    # the loss the resumed run must see first: step 16's batch on the saved state
    cfg = configs.get_smoke("starcoder2-3b")
    model, opt = init_train_state(torch.Generator().manual_seed(1), cfg, TrainConfig(),
                                  device="cpu")
    restored, step, report = mgr.load(train_state(model, opt))
    assert step == 16 and report.mode == ("repair" if lose_shard else "direct")
    restored_params = named_arrays(cfg, restored["params"])  # the reference's tree
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(restored_params[name])
        batch = SyntheticStream(cfg, DataConfig(batch=4, seq=64), device="cpu").batch_at(16)
        want, _ = loss_fn(model, cfg, TrainConfig(), batch)
    capsys.readouterr()
    assert launch_train.main(args + ["--steps", "24", "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from step 16 (restore mode={report.mode})" in out
    assert _first_loss(out) == pytest.approx(want.item(), abs=1e-4)
    assert launch_train.main(args + ["--steps", "24", "--resume"]) == 0  # nothing left to do
    assert "nothing to do" in capsys.readouterr().out


def test_launcher_success_test():
    assert launch_train.training_ok([6.0, 5.0])
    assert launch_train.training_ok([6.0, 6.0])
    assert not launch_train.training_ok([5.0, 6.0])
    assert not launch_train.training_ok([6.0, float("nan")])
    assert not launch_train.training_ok([])


def test_launcher_with_microbatches_and_no_checkpoint():
    assert launch_train.main(LAUNCH + ["--steps", "12", "--microbatches", "2",
                                       "--schedule", "cosine"]) == 0


def test_e2e_demo_repairs_a_lost_shard_and_trains_on(tmp_path):
    got = train_e2e.main(["--device", "cpu", "--d-model", "64", "--layers", "2", "--vocab", "512",
                          "--steps", "20", "--ckpt-every", "4", "--seq", "64", "--lr", "3e-3",
                          "--ckpt-dir", str(tmp_path)])
    plan = make_code("DRC", 9, 6, 3).repair_plan(2)
    # the crash at step 10 restores step 8's checkpoint: steps 8 and 9 run twice
    assert got["mode"] == "repair" and got["restored_step"] == 8
    assert got["byte_equal"]
    assert got["cross_rack_blocks"] == plan.traffic_blocks()["cross_rack_blocks"]
    assert len(got["losses"]) == 22
    assert got["losses"][-1] < got["losses"][0]


def test_elastic_demo_runs():
    got = elastic_recovery.main(["--device", "cpu"])
    assert got["decode_action"] == got["decode_mode"] == "decode" and got["decoded_equal"]
    assert got["rescaled_spec"] == ("DRC", 6, 4, 3) and got["rescaled_equal"]
    assert got["rescaled_mode"] == "repair"
    assert got["relayer_order"] == [0, 2, 1]
    assert math.isfinite(got["resumed_loss"])
