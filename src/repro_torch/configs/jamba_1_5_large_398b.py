"""jamba-1.5-large-398b [arXiv:2403.19887].

72L d=8192, attn:mamba 1:7 interleave (1 attention layer per 8-layer
period, at index 4), MoE every other layer (16 experts top-2, ff=24576),
64H kv=8, vocab 65536.  Jamba ships Mamba-1 blocks; the reference package
standardises on Mamba-2 SSD (state 128, head_dim 64), the chunked form of
the same SSM family, and the port keeps its choice.
"""
from repro_torch.configs.base import (ArchConfig, Block, LayerGroup, MoEConfig,
                                      SSMConfig)

_PERIOD = tuple(
    Block("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=8, chunk_size=256),
    groups=(LayerGroup(9, _PERIOD),),
)

_SMOKE_PERIOD = tuple(
    Block("attn" if i == 1 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(4)
)

SMOKE = ArchConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8,
                  n_groups=2, chunk_size=8),
    groups=(LayerGroup(1, _SMOKE_PERIOD),),
)
