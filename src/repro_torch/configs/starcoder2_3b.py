"""starcoder2-3b [dense]: 30L d=3072 24H (kv=2) d_ff=12288 vocab=49152.

GQA + RoPE. [arXiv:2402.19173; hf]
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    mlp_act="gelu",
    qkv_bias=True,
    norm="layernorm",
    rope_theta=1e5,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-3b-smoke", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=384, vocab=512, remat="none",
    )
