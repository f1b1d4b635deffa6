"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) expert_ff=512 vocab=49155 (padded ->49408),
MoE 32 experts top-8, every layer MoE.
"""
from repro_torch.configs.base import (ArchConfig, Block, LayerGroup, MoEConfig,
                                      pad_vocab)

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=pad_vocab(49155),
    rope_theta=10000.0, tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512),
    groups=(LayerGroup(24, (Block("attn", "moe"),)),),
)

SMOKE = ArchConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=32, vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32),
    groups=(LayerGroup(2, (Block("attn", "moe"),)),),
)
