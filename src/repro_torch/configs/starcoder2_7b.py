"""starcoder2-7b [dense]: 32L d=4608 36H (kv=4) d_ff=18432 vocab=49152.

GQA + RoPE, GeLU MLP with biases, layernorm. [arXiv:2402.19173; hf]
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    mlp_act="gelu",
    qkv_bias=True,
    norm="layernorm",
    rope_theta=1e5,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-7b-smoke", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, remat="none",
    )
