"""Architecture registry: ``get_config(<arch id>)`` resolves here.

Each module defines ``CONFIG`` (the exact published configuration) and
``smoke()`` (a reduced same-family config for CPU tests).  A copy of the
reference registry (``repro.configs``) with the import paths changed;
``input_specs``, which builds JAX shape stand-ins, is not carried over.
"""
from __future__ import annotations

import importlib

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
