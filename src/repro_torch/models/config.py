"""Architecture configuration (the --arch registry's value type).

One dataclass covers all ten assigned architecture families; family-
specific knobs are optional fields.  `configs/<arch>.py` instantiates the
exact published configuration plus a `smoke()` reduction of the same
family for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # 'expert' shards the expert dim over the model axis (EP);
    # 'ffn' shards each expert's hidden dim (TP).  EP needs
    # num_experts % model_axis == 0.
    sharding: str = "expert"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # block flavour
    parallel_block: bool = False  # command-r: attn & mlp in parallel
    mlp_act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    logit_scale: float = 1.0
    residual_scale: float = 1.0  # minicpm depth scaling
    embed_scale: float = 1.0  # minicpm mup-style embedding scale
    # moe / ssm / hybrid
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba2): one shared attention+mlp block invoked every
    # `shared_attn_every` ssm blocks (weight-tied across invocations)
    shared_attn_every: int = 0
    # xlstm: every `slstm_every`-th block is an sLSTM block
    slstm_every: int = 0
    # enc-dec (whisper): decoder cross-attends to encoder states
    encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500  # stub frame count
    # modality frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"
    vision_tokens: int = 0  # vlm: patch embeddings prepended to the text
    # memory/serving
    supports_long_context: bool = False  # sub-quadratic decode path
    # training numerics
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # bf16 for the huge MoE configs
    remat: str = "full"  # none | dots | full
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab axis shards
        cleanly on any mesh (e.g. minicpm's prime-ish 122753 -> 122880)."""
        return (self.vocab + 255) // 256 * 256

    @property
    def params_billions(self) -> float:
        return self.count_params() / 1e9

    def count_params(self) -> int:
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe:
            ff = 3 * d * self.moe.d_ff_expert * self.moe.num_experts
            ff += d * self.moe.num_experts  # router
        elif self.mlp_act == "swiglu":
            ff = 3 * d * self.d_ff
        else:
            ff = 2 * d * self.d_ff
        per_layer = attn + ff
        if self.ssm is not None:
            d_in = d * self.ssm.expand
            ssm_per = d * (2 * d_in + 2 * self.ssm.d_state) + d_in * d
            if self.family == "ssm":
                per_layer = ssm_per + ff
            else:  # hybrid: most layers are ssm
                per_layer = ssm_per
        total = emb + self.n_layers * per_layer
        if self.encoder_decoder:
            total += self.encoder_layers * (attn + ff)  # encoder stack
            total += self.n_layers * attn  # cross attention
        if self.shared_attn_every:
            total += attn + 3 * d * self.d_ff  # one shared block
        return int(total)

    def active_params(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if not self.moe:
            return self.count_params()
        d = self.d_model
        dense = dataclasses.replace(self, moe=None, d_ff=0)
        ff_active = 3 * d * self.moe.d_ff_expert * self.moe.top_k
        return dense.count_params() + self.n_layers * (
            ff_active + d * self.moe.num_experts
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: what gets lowered for the dry-run."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
