"""internvl2-1b [vlm]: 24L d=896 14H (kv=2) d_ff=4864 vocab=151655.

InternViT frontend is a STUB: input_specs supplies 256 precomputed patch
embeddings prepended to the token stream (Qwen2-0.5B-like LM backbone).
[arXiv:2404.16821; hf]
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    mlp_act="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    vision_tokens=256,
    frontend="vision",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", n_layers=2, d_model=112, n_heads=7,
        n_kv_heads=1, d_ff=320, vocab=512, vision_tokens=16, remat="none",
    )
