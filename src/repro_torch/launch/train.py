"""Training launcher.

Runs real steps on one device (an H100 by default, the CPU with ``--device
cpu``), the counterpart of ``repro.launch.train`` without its ``--dryrun``:
erasure-coded checkpoints every ``--ckpt-every`` steps through
``CheckpointManager`` (encode and repair through the GF kernel on a CUDA
device), ``--resume`` from the newest checkpoint (restored through the
layered repair when a shard is lost, and copied into the live parameters and
optimizer state in place), and the restart-safe synthetic stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --smoke \\
      --steps 50 --batch 4 --seq 128 --ckpt-dir /path/to/ckpt

``main(argv)`` returns the exit code: 0 when every loss is finite and the
last is no higher than the first (``training_ok``).
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_config, get_smoke
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
from repro_torch.train.checkpoint import CheckpointManager, copy_state_


def training_ok(losses: list[float]) -> bool:
    """The launcher's success test: losses finite, the last no higher than
    the first."""
    return bool(losses) and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] + 1e-6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine", "constant"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-code", default="DRC:9:6:3", help="family:n:k:r")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(state_dtype=cfg.opt_state_dtype),
        schedule=ScheduleConfig(
            kind=args.schedule, peak_lr=args.lr, total_steps=args.steps,
            warmup_steps=max(2, args.steps // 20),
        ),
        microbatches=args.microbatches,
    )
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model, opt = init_train_state(gen, cfg, tcfg, device=device)
    stream = SyntheticStream(cfg, DataConfig(seed=args.seed, batch=args.batch, seq=args.seq),
                             device=device)
    step_fn = make_train_step(cfg, tcfg)

    mgr = None
    start = 0
    if args.ckpt_dir:
        fam, n, k, r = args.ckpt_code.split(":")
        mgr = CheckpointManager(args.ckpt_dir, family=fam, n=int(n), k=int(k), r=int(r),
                                device=device)
        if args.resume and mgr.steps():
            live = train_state(model, opt)
            restored, start, report = mgr.load(live)
            copy_state_(live, restored)
            del restored
            print(f"[train] resumed from step {start} (restore mode={report.mode})")

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = stream.batch_at(step)
        model, opt, metrics = step_fn(model, opt, batch, step)
        losses.append(metrics["loss"].item())
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(
                f"[train] step={step} loss={losses[-1]:.4f} "
                f"lr={metrics['lr'].item():.2e} gnorm={metrics['grad_norm'].item():.3f} "
                f"tok/s={tok_s:.0f}"
            )
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, train_state(model, opt))
            print(f"[train] erasure-coded checkpoint @ step {step + 1}")
    if not losses:
        print(f"[train] nothing to do: resumed at step {start} of {args.steps}")
        return 0
    if mgr:
        mgr.save(args.steps, train_state(model, opt))
    print(f"[train] done: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"{'(improved)' if losses[-1] < losses[0] else ''}")
    return 0 if training_ok(losses) else 1


if __name__ == "__main__":
    raise SystemExit(main())
