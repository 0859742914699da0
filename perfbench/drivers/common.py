"""Set-up steps the drivers share: the program's code object, its encode
step, the GF kernel's library, and a pool of seeded stripes."""
from __future__ import annotations

import time

import torch

from perfbench import data


def port_code(cfg: dict, device: torch.device, split: dict[str, float]):
    """(the program's code for ``cfg``, its encode step at the config's
    sub), with the GF kernel built or loaded on a card."""
    t = time.perf_counter()
    from repro_torch.core.codes.registry import make_code
    from repro_torch.kernels import build
    from repro_torch.train.checkpoint import make_encode_step
    split["imports"] = split.get("imports", 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    code = make_code(cfg["family"], cfg["n"], cfg["k"], cfg["r"])
    if code.alpha != cfg["alpha"]:
        raise ValueError(f"{code} has alpha {code.alpha}, the config says {cfg['alpha']}")
    if device.type == "cuda":
        build.load("gf_matmul")
    split["build"] = time.perf_counter() - t
    return code, make_encode_step(code, cfg["sub_bytes"], device)


def encoded_pool(cfg: dict, stripes: int, seed: int, device: torch.device, encode,
                 split: dict[str, float]) -> torch.Tensor:
    """(stripes, n*alpha, sub): seeded data, parity encoded by ``encode``."""
    t = time.perf_counter()
    pool = data.new_pool(cfg, stripes, seed, device)
    for s in range(stripes):
        encode(pool[s])
    sync(device)
    split["data"] = time.perf_counter() - t
    return pool


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
