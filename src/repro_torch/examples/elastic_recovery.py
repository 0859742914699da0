"""Elastic scaling + fault tolerance.

The port's counterpart of ``examples/elastic_recovery_demo.py``:

1. Train a few steps; encode the state with DRC(9,6,3) (9 shards, 3 pods).
2. Lose two shards -> MDS decode.
3. *Elastically rescale* the stripe to DRC(6,4,3) (the cluster shrank to 6
   failure domains) and restore from it with one shard missing.
4. The straggler monitor steers relayer placement away from a slow pod.
5. Resume training from the restored state.

  PYTHONPATH=src python -m repro_torch.examples.elastic_recovery [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke
from repro_torch.train import (
    DataConfig,
    SyntheticStream,
    TrainConfig,
    init_train_state,
    make_train_step,
    train_state,
)
from repro_torch.train.checkpoint import copy_state_, encode_state, restore_state, state_to_bytes
from repro_torch.train.fault_tolerance import FaultToleranceManager


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cfg = get_smoke("starcoder2_3b")
    tcfg = TrainConfig()
    model, opt = init_train_state(torch.Generator(device=device).manual_seed(0), cfg, tcfg,
                                  device=device)
    stream = SyntheticStream(cfg, DataConfig(batch=2, seq=64), device=device)
    step_fn = make_train_step(cfg, tcfg)

    for step in range(3):
        model, opt, m = step_fn(model, opt, stream.batch_at(step), step)
    print(f"[elastic] trained 3 steps, loss={m['loss'].item():.4f}")

    mgr = FaultToleranceManager()
    state = train_state(model, opt)
    want = state_to_bytes(state)[0]
    ckpt = encode_state(state, family="DRC", n=9, k=6, r=3, step=3, device=device)
    print(f"[elastic] encoded state into DRC(9,6,3): "
          f"{sum(p.numel() for p in ckpt.payloads.values()) / 2**20:.1f} MiB coded")

    lost = [1, 7]
    action = mgr.plan_recovery(ckpt, lost)
    got, report, _ = mgr.execute(ckpt, state, lost)
    decoded_equal = torch.equal(state_to_bytes(got)[0], want)
    print(f"[elastic] lost shards {lost}: action={action.kind}, "
          f"restore mode={report.mode}, bit-exact={decoded_equal}")

    new_ckpt = mgr.rescale(ckpt, state, n=6, k=4, r=3)
    print(f"[elastic] rescaled stripe to DRC{new_ckpt.code_spec[1:]} "
          f"(cluster shrank 9 -> 6 domains)")
    state2, rep2 = restore_state(new_ckpt, state, available={0, 1, 3, 4, 5})
    rescaled_equal = torch.equal(state_to_bytes(state2)[0], want)
    print(f"[elastic] degraded restore from rescaled stripe: mode={rep2.mode}, "
          f"bit-exact={rescaled_equal}")

    for pod in range(3):
        for _ in range(8):
            mgr.straggler.report(pod, 2.0 if pod == 1 else 1.0)
    order = mgr.straggler.preferred_relayer_order([0, 1, 2])
    print(f"[elastic] straggler mitigation: pod 1 slow -> relayer order {order}")

    copy_state_(state, state2)
    model, opt, m = step_fn(model, opt, stream.batch_at(3), 3)
    loss = m["loss"].item()
    print(f"[elastic] resumed training, loss={loss:.4f} — demo OK")
    if not (decoded_equal and rescaled_equal):
        raise RuntimeError("a restored state is not bit-exact")
    return {"decode_action": action.kind, "decode_mode": report.mode,
            "decoded_equal": decoded_equal, "rescaled_spec": new_ckpt.code_spec,
            "rescaled_mode": rep2.mode, "rescaled_equal": rescaled_equal,
            "relayer_order": order, "resumed_loss": loss}


if __name__ == "__main__":
    main()
