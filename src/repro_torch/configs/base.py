"""Architecture config dataclasses.

One frozen dataclass describes every assigned architecture. Layer structure
is expressed as *layer groups*: a group is a repeated sequence of blocks,
each block = (mixer, ffn). In the PyTorch port a group is an ``nn.ModuleList`` of
``repeat`` blocks; the group structure is kept so configs read the same.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mla", "mamba"]
Ffn = Literal["mlp", "moe", "none"]


def pad_vocab(v: int, multiple: int = 128) -> int:
    """Pad vocab to a multiple of 128, as the reference package does, so
    both packages give the same table shapes."""
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # expert hidden dim (0 -> use arch d_ff)
    num_shared_experts: int = 0   # DeepSeek-style always-on experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class Block:
    mixer: Mixer = "attn"
    ffn: Ffn = "mlp"


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    repeat: int
    blocks: tuple[Block, ...]

    @property
    def num_layers(self) -> int:
        return self.repeat * len(self.blocks)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    groups: tuple[LayerGroup, ...] = ()

    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None  # SWA window (tokens) or None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: Literal["silu", "gelu"] = "silu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False

    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0           # e.g. 1500 audio frames
    # modality frontend stub: None | "audio" | "vision"
    frontend: str | None = None
    num_frontend_tokens: int = 0       # vision patch tokens prepended

    # MTP (DeepSeek multi-token prediction) — extra head depth
    mtp_depth: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.num_heads))
        if not self.groups:
            object.__setattr__(
                self, "groups",
                (LayerGroup(self.num_layers, (Block("attn", "mlp"),)),))
        n = sum(g.num_layers for g in self.groups)
        if n != self.num_layers:
            raise ValueError(f"{self.name}: groups give {n} layers, "
                             f"config says {self.num_layers}")

    @property
    def attention_free(self) -> bool:
        return all(b.mixer == "mamba" for g in self.groups for b in g.blocks)

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (SSM/hybrid/SWA)."""
        return (self.attention_free or self.family == "hybrid"
                or self.sliding_window is not None)

    def scaled(self, **kw) -> "ArchConfig":
        """Return a reduced copy (smoke tests). kw overrides fields."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
