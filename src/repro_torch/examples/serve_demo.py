"""Batched serving demo: prefill a batch of prompts, decode new tokens.

The port's counterpart of ``examples/serve_demo.py``: the xlstm-125m smoke
config (an O(1)-per-token recurrent state), a GQA transformer
(starcoder2-3b) and the zamba2 hybrid (Mamba2 states plus a shared
attention block's KV cache), side by side through the one ``ServeEngine``
and its decode-state API.  Weights are random, from a seed.

  PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke
from repro_torch.models import backbone
from repro_torch.serve import ServeEngine

ARCHS = ("xlstm_125m", "starcoder2_3b", "zamba2_1p2b")


def run(arch: str, device: torch.device, *, batch=4, prompt_len=16, gen=24,
        temperature=0.8) -> dict:
    cfg = get_smoke(arch)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    model = backbone.init_model(cfg, generator=g, device=device)
    eng = ServeEngine(cfg, model, batch=batch, kv_len=prompt_len + gen + 8, device=device)
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=device)
    t0 = time.perf_counter()
    logits = eng.prefill(prompts)
    t1 = time.perf_counter()
    toks = eng.generate(gen, generator=g, temperature=temperature)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    print(f"[serve] {arch}: prefill {batch}x{prompt_len} in {t1 - t0:.2f}s; "
          f"generated {batch}x{gen} tokens in {t2 - t1:.2f}s "
          f"({batch * gen / (t2 - t1):.0f} tok/s)")
    print(f"[serve]   sample continuation: {toks[0, :12].tolist()}")
    return {"tokens": toks.cpu(), "prefill_logits_finite": bool(torch.isfinite(logits).all()),
            "position": eng.position}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    out = {arch: run(arch, device, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen)
           for arch in ARCHS}
    print("serve demo OK")
    return out


if __name__ == "__main__":
    main()
