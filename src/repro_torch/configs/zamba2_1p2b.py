"""zamba2-1.2b [hybrid]: 38 Mamba2 blocks d=2048, ssm_state=64, plus one
weight-shared attention+MLP block (32H, d_ff=8192) invoked every 6 blocks.

O(1)-per-token SSM decode -> runs the long_500k shape.
[arXiv:2411.15242; hf]
"""
import dataclasses

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    mlp_act="gelu",
    # chunk=64: the SSD intra-chunk decay tensor is O(B·ck²·H) f32 — at
    # ck=256 that is 16 GiB/device on train_4k; 64 is the standard choice
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64),
    shared_attn_every=6,
    tie_embeddings=True,
    supports_long_context=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=5, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        shared_attn_every=2, remat="none",
    )
