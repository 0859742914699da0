"""command-r-35b [dense]: 40L d=8192 64H (kv=8) d_ff=22528 vocab=256000.

Cohere-style: parallel attention/FFN block, no biases, tied embeddings,
logit scaling. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    parallel_block=True,
    mlp_act="swiglu",
    norm="layernorm",
    tie_embeddings=True,
    logit_scale=0.0625,
    rope_theta=8e6,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="command-r-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=352, vocab=512, remat="none",
    )
