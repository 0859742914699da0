"""whisper-small [audio]: enc-dec 12L+12L d=768 12H d_ff=3072 vocab=51865.

Conv frontend is a STUB: input_specs supplies precomputed frame
embeddings (1500 frames) to the encoder. [arXiv:2212.04356; unverified]
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    mlp_act="gelu",
    norm="layernorm",
    encoder_decoder=True,
    encoder_layers=12,
    encoder_seq=1500,
    frontend="audio",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, encoder_layers=2,
        d_model=96, n_heads=6, n_kv_heads=6, d_ff=256, vocab=512,
        encoder_seq=32, remat="none",
    )
