"""Synthetic-token data pipeline.

The PyTorch counterpart of ``repro.train.data``, with its own copy of the
reference's numpy generator: the batch at ``step`` is a pure function of
(seed, step), drawn with the same ``np.random.default_rng`` calls in the same
order, so both packages see the same tokens and resuming from a checkpoint
replays the exact stream without any state file.  Labels are the tokens
shifted by one, with -1 (ignored) at the last position.  The arrays move to
the stream's device as int32 (side inputs as bf16).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 512


class SyntheticStream:
    """Markov-ish synthetic token stream with learnable structure."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:  # check: ignore[uninstrumented-entrypoint] synthetic data
        rng = np.random.default_rng((self.data.seed << 20) ^ step)
        b, s = self.data.batch, self.data.seq
        v = self.cfg.vocab
        base = rng.integers(0, v, size=(b, 1), dtype=np.int32)
        drift = rng.integers(0, 17, size=(b, s), dtype=np.int32)
        toks = (base + np.cumsum(drift, axis=1)) % v
        tokens = toks.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.family == "vlm" and self.cfg.vision_tokens:
            vt = self.cfg.vision_tokens
            out["vis_embeds"] = (rng.standard_normal((b, vt, self.cfg.d_model))
                                 .astype(np.float32) * 0.02)
            out["labels"] = np.concatenate([np.full((b, vt), -1, np.int32), labels], axis=1)
        if self.cfg.family == "audio":
            out["frames"] = (rng.standard_normal((b, self.cfg.encoder_seq, self.cfg.d_model))
                             .astype(np.float32) * 0.02)
        batch = {}
        for name, a in out.items():
            t = torch.from_numpy(a)
            if t.is_floating_point():  # side inputs: bf16, as the reference's
                t = t.to(torch.bfloat16)
            batch[name] = t.to(self.device)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
