"""End-to-end training with erasure-coded fault tolerance.

The port's counterpart of ``examples/train_e2e.py``: trains a small
minicpm-family model on the synthetic stream, checkpoints the full training
state (parameters and AdamW state) with DRC(9,6,3) every N steps, then *kills
a checkpoint shard mid-run* (deletes ``node_2.bin``) and restarts from the
damaged checkpoint.  The restore runs the paper's layered repair (degraded
read) through the GF kernel on a CUDA device; the restored state is copied
into the live one in place, checked byte-equal to the state that was saved,
and training continues.

  PYTHONPATH=src python -m repro_torch.examples.train_e2e [--device cpu]

Defaults are the reference's sizes (d 256, 4 layers, vocab 8192, 60 steps of
4 x 256 tokens).  Scale up with ``--d-model 768 --layers 12 --steps 300``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import statistics
import tempfile
import time

import torch

from repro_torch.configs import get_smoke
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
from repro_torch.train.checkpoint import CheckpointManager, copy_state_, state_to_bytes


def run(args, ckpt_dir: str) -> dict:
    cfg = dataclasses.replace(
        get_smoke("minicpm_2b"),
        name="minicpm-e2e",
        d_model=args.d_model,
        n_layers=args.layers,
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(4, args.d_model // 64),
        d_ff=args.d_model * 3,
        vocab=args.vocab,
    )
    tcfg = TrainConfig(
        optimizer=AdamWConfig(),
        schedule=ScheduleConfig(kind="wsd", peak_lr=args.lr, total_steps=args.steps,
                                warmup_steps=5),
    )
    device = torch.device(args.device)
    model, opt = init_train_state(torch.Generator(device=device).manual_seed(0), cfg, tcfg,
                                  device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[e2e] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens on {device}")

    mgr = CheckpointManager(ckpt_dir, family="DRC", n=9, k=6, r=3, device=device)
    stream = SyntheticStream(cfg, DataConfig(batch=args.batch, seq=args.seq), device=device)
    step_fn = make_train_step(cfg, tcfg)

    losses = []
    step_s = []  # host clock of each step; reading its loss waits for the device
    saved = {}  # step -> the serialized state that was checkpointed
    crash_at = args.steps // 2
    crashed = False
    result = {}
    step = 0
    while step < args.steps:
        t = time.perf_counter()
        model, opt, m = step_fn(model, opt, stream.batch_at(step), step)
        losses.append(m["loss"].item())
        step_s.append(time.perf_counter() - t)
        if step % 10 == 0:
            print(f"[e2e] step={step:3d} loss={losses[-1]:.4f}")
        step += 1
        if step % args.ckpt_every == 0:
            mgr.save(step, train_state(model, opt))
            saved[step] = state_to_bytes(train_state(model, opt))[0]
        if step == crash_at and not crashed:
            crashed = True
            # ----- simulated node failure -----
            last = mgr.steps()[-1]
            os.remove(os.path.join(mgr._stepdir(last), "node_2.bin"))
            print(f"[e2e] killed checkpoint shard node_2 of step {last}; "
                  f"restarting from the damaged checkpoint")
            live = train_state(model, opt)
            t = time.perf_counter()
            restored, step, report = mgr.load(live)
            copy_state_(live, restored)
            del restored
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            restore_s = time.perf_counter() - t
            equal = torch.equal(state_to_bytes(live)[0], saved[step])
            result = {"restored_step": step, "mode": report.mode,
                      "cross_rack_blocks": report.cross_rack_blocks, "byte_equal": equal,
                      "restore_s": restore_s}
            print(f"[e2e] restored via {report.mode} "
                  f"(cross-rack={report.cross_rack_blocks:.1f} blocks, byte-equal={equal}) "
                  f"in {restore_s:.3f} s; resuming at step {step}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not improve: {losses[0]:.4f} -> {losses[-1]:.4f}")
    # the median step, the first (warm-up) one left out
    step_ms = statistics.median(step_s[1:] or step_s) * 1e3
    tokens_per_s = args.batch * args.seq / (step_ms / 1e3)
    print(f"[e2e] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} OK; median step "
          f"{step_ms:.3f} ms (host clock), {tokens_per_s:.0f} tokens/s")
    return {"losses": losses, "step_ms": step_ms, "tokens_per_s": tokens_per_s, **result}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None, help="default: a temporary directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_every > args.steps // 2:
        raise ValueError("--ckpt-every must leave a checkpoint before the crash at --steps / 2")
    if args.ckpt_dir:
        return run(args, args.ckpt_dir)
    with tempfile.TemporaryDirectory() as d:
        return run(args, d)


if __name__ == "__main__":
    main()
