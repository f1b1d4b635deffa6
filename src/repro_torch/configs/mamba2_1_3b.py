"""mamba2-1.3b [arXiv:2405.21060].

48L d_model=2048 attention-free SSD, ssm_state=128, d_inner=4096,
head_dim=64 (64 ssm heads), vocab 50280 (padded ->50304).
"""
from repro_torch.configs.base import (ArchConfig, Block, LayerGroup, SSMConfig,
                                      pad_vocab)

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=64, num_kv_heads=0,
    d_ff=0, vocab_size=pad_vocab(50280), head_dim=64, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    groups=(LayerGroup(48, (Block("mamba", "none"),)),),
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=16, num_kv_heads=0,
    d_ff=0, vocab_size=256, head_dim=8,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8,
                  n_groups=2, chunk_size=8),
    groups=(LayerGroup(2, (Block("mamba", "none"),)),),
)
