"""Architecture registry: ``get_config(<arch id>)`` resolves here.

Each module defines ``CONFIG`` (the exact published configuration) and
``smoke()`` (a reduced same-family config for CPU tests).  A copy of the
reference registry (``repro.configs``) with the import paths changed;
``input_specs`` builds the dry run's batch as tensors of the reference's
shapes and dtypes (meta tensors by default, fake ones under a
``FakeTensorMode``), never allocating.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig  # noqa: F401

ARCHS = [
    "command_r_35b",
    "minicpm_2b",
    "starcoder2_7b",
    "starcoder2_3b",
    "xlstm_125m",
    "internvl2_1b",
    "dbrx_132b",
    "grok_1_314b",
    "whisper_small",
    "zamba2_1p2b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({
    "command-r-35b": "command_r_35b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-7b": "starcoder2_7b",
    "starcoder2-3b": "starcoder2_3b",
    "xlstm-125m": "xlstm_125m",
    "internvl2-1b": "internvl2_1b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "whisper-small": "whisper_small",
    "zamba2-1.2b": "zamba2_1p2b",
})


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ALIAS.get(name, name)}")
    return mod.CONFIG


def get_smoke(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ALIAS.get(name, name)}")
    return mod.smoke()


def list_archs() -> list[str]:
    return list(ARCHS)


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Which of the four shape cells an architecture runs.

    long_500k needs a sub-quadratic decode path (SSM/hybrid); pure
    full-attention archs skip it.
    """
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        shapes.append("long_500k")
    return shapes


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str, *,
                device: str | torch.device = "meta") -> dict[str, torch.Tensor]:
    """The batch of one dry-run cell: ``torch.empty`` on ``device`` of the
    reference's ``input_specs`` shapes and dtypes (``meta`` allocates
    nothing; under a ``FakeTensorMode`` any device gives fake tensors).
    Train and prefill: ``tokens`` (B, S less the vlm's patches) int32,
    the vlm's ``vis_embeds`` and the audio ``frames`` bf16, train's
    ``labels`` (B, S) int32; decode: ``tokens`` (B, 1) int32 against a
    cache of S."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    batch: dict = {}
    if shape.kind in ("train", "prefill"):
        s_text = s
        if cfg.family == "vlm" and cfg.vision_tokens:
            s_text = s - cfg.vision_tokens
            batch["vis_embeds"] = spec((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        batch["tokens"] = spec((b, s_text), torch.int32)
        if shape.kind == "train":
            batch["labels"] = spec((b, s), torch.int32)
        if cfg.family == "audio":
            batch["frames"] = spec((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    else:  # decode: one new token against a kv_len = seq cache
        batch["tokens"] = spec((b, 1), torch.int32)
    return batch
