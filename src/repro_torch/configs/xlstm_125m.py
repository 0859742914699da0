"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304 — sLSTM + mLSTM blocks.

d_ff=0 per the assignment (no separate MLP; the m/sLSTM blocks carry the
capacity).  O(1)-per-token decode -> runs the long_500k shape.
[arXiv:2405.04517; unverified]
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=4,  # every 4th block is sLSTM (9 mLSTM : 3 sLSTM)
    tie_embeddings=True,
    supports_long_context=True,
    scan_layers=False,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", n_layers=4, d_model=64, n_heads=2,
        n_kv_heads=2, vocab=512, remat="none",
    )
