"""dbrx-132b [moe]: 40L d=6144 48H (kv=8) d_ff=10752/expert vocab=100352.

16 experts, top-4 (fine-grained).  Expert dim shards over the model axis
(EP); optimizer state kept in bf16 so the 256-chip v5e pod fits.
[hf:databricks/dbrx-base; unverified]
"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    mlp_act="swiglu",
    norm="layernorm",
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    opt_state_dtype="bfloat16",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="dbrx-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=256, vocab=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
        opt_state_dtype="float32", remat="none",
    )
