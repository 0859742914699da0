"""minicpm-2b [dense]: 40L d=2304 36H (MHA) d_ff=5760 vocab=122753.

WSD schedule; mup-style depth/embed scaling (llama-like arch).
[arXiv:2404.06395; hf]
"""
import dataclasses
import math

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    mlp_act="swiglu",
    tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(40),  # scale_depth / sqrt(L)
    embed_scale=12.0,
    rope_theta=10000.0,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm-smoke", n_layers=2, d_model=144, n_heads=4,
        n_kv_heads=4, d_ff=384, vocab=512,
        residual_scale=1.4 / math.sqrt(2), remat="none",
    )
