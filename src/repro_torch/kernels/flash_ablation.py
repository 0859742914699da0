"""Ablation of the bf16 flash kernel's design on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_ablation [--rounds 6] [--reps 20]

Builds ``csrc/flash_attention.cu`` as it is (``final``) and, from edited
copies of its text, with steps of its design switched off:

* ``no_pingpong``: the two consumer warpgroups issue their products without
  taking turns;
* ``no_overlap``: a warpgroup's softmax of kv tile t waits for its own PV of
  tile t - 1 instead of running beside it;
* ``not_persistent``: one CTA per work item, as many as there are items,
  instead of one per SM walking them (ping-pong and overlap kept);
* ``overlap_only``: neither ping-pong nor persistence;
* ``serial``: none of the three: each warpgroup runs QK^T, softmax and PV
  one after the other;
* ``no_exp``: the exponential replaced by a multiply (wrong results, timed
  only): how much of the time the MUFU's exp2 holds.

Every variant but ``no_exp`` is held against ``flash_attention_ref`` at a few
shapes (bf16 atol 3e-2).  Then all of them and PyTorch's
``scaled_dot_product_attention`` are timed in turns with CUDA events at the
model's prefill shape (StarCoder2-3B: q (4, 4096, 24, 128), k/v (4, 4096, 2,
128), bf16, causal), ``--rounds`` rounds of ``--reps`` launches.  Prints one
JSON line per round, then the medians, the card's name and power limit.  It
needs a card and ``nvcc``; it imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from . import build
from .flash_attention import bind, flash_attention_ref, launch

FAST_EXP = '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
# each edit switches one step of the design off
EDITS = {
    "pingpong": ("const bool pingpong = n_mine > 0 && tiles_of(x.q0 + 64 * (1 - c)) == n_mine;",
                 "const bool pingpong = false;"),
    "overlap": ("wgmma_wait<1>();  // S of tile t", "wgmma_wait<0>();  // S of tile t"),
    "persistent": ("const int grid = static_cast<int>(n_work < sms ? n_work : sms);",
                   "const int grid = static_cast<int>(n_work);"),
    "exp": (FAST_EXP, "  y = x * 1e-3f;"),
}
VARIANTS = {
    "final": [], "no_pingpong": ["pingpong"], "no_overlap": ["overlap"],
    "not_persistent": ["persistent"], "overlap_only": ["pingpong", "persistent"],
    "serial": ["pingpong", "overlap", "persistent"], "no_exp": ["exp"],
}
CHECK_SHAPES = [  # b, sq, sk, h, kvh, d, causal
    (1, 100, 77, 4, 2, 128, True), (2, 1050, 1050, 96, 8, 64, True),
    (4, 50, 300, 80, 4, 64, False), (2, 512, 512, 24, 2, 128, True),
]
MODEL_SHAPE = (4, 4096, 24, 2, 128)


def variant_sources() -> dict[str, str]:
    """The source of each variant, by name."""
    src = build.SOURCES["flash_attention"].read_text()
    out = {}
    for name, steps in VARIANTS.items():
        text = src
        for step in steps:
            old, new = EDITS[step]
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(sources: dict[str, str]) -> dict[str, object]:
    """Each variant built into build/kernels/ (one nvcc each, all at once)
    and bound: name -> its ``flash_attention_launch``."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in sources.items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        paths[name] = build.BUILD_DIR / f"flash_ablation_{name}-{digest}.cu"
        paths[name].write_text(text)
    libs = build.compile_sources(paths)
    return {name: bind(ctypes.CDLL(str(libs[name]))) for name in sources}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls (warm)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    fns = build_variants(variant_sources())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    for b, sq, sk, h, kvh, d, causal in CHECK_SHAPES:
        q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d)
        want = flash_attention_ref(q, k, v, causal=causal).float()
        for name, fn in fns.items():
            if name == "no_exp":
                continue
            err = float((launch(fn, q, k, v, causal).float() - want).abs().max())
            if err > 3e-2:
                raise RuntimeError(f"{name} at {(b, sq, sk, h, kvh, d, causal)}: error {err}")
    print(json.dumps({"checked": [n for n in fns if n != "no_exp"], "shapes": CHECK_SHAPES}))

    b, s, h, kvh, d = MODEL_SHAPE
    q, k, v = rand(b, s, h, d), rand(b, s, kvh, d), rand(b, s, kvh, d)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    calls = {name: (lambda fn=fn: launch(fn, q, k, v, True)) for name, fn in fns.items()}
    calls["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    times: dict[str, list[float]] = {name: [] for name in calls}
    for rnd in range(args.rounds):
        for name, call in calls.items():
            times[name].append(cuda_ms(call, args.reps))
        print(json.dumps({"round": rnd, "ms": {n: t[-1] for n, t in times.items()}}))
    print(json.dumps({"shape": list(MODEL_SHAPE), "rounds": args.rounds, "reps": args.reps,
                      "median_ms": {n: float(np.median(t)) for n, t in times.items()},
                      "first_round_ms": {n: t[0] for n, t in times.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
