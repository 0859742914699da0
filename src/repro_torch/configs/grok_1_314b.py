"""grok-1-314b [moe]: 64L d=6144 48H (kv=8) d_ff=32768/expert vocab=131072.

8 experts, top-2.  8 experts don't divide the 16-way model axis, so the
expert FFN dim carries the model sharding instead (MoEConfig.sharding
is advisory; resolve_spec drops non-dividing axes automatically).
Optimizer state bf16 (see DESIGN.md §6).  [hf:xai-org/grok-1; unverified]
"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    mlp_act="gelu",
    rope_theta=1e4,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768, sharding="ffn"),
    opt_state_dtype="bfloat16",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="grok-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=256, vocab=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
        opt_state_dtype="float32", remat="none",
    )
