"""deepseek-v3-671b [arXiv:2412.19437].

61L d_model=7168 128H MLA d_ff(expert)=2048 vocab=129280, 1 shared + 256
routed experts top-8, first 3 layers dense (ff=18432), MTP depth 1.
Assignment sheet lists d_ff=2048 = the *expert* width; the dense layers use
the model's published 18432.
"""
from repro_torch.configs.base import (ArchConfig, Block, LayerGroup, MLAConfig,
                                      MoEConfig, pad_vocab)

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=pad_vocab(129280),
    rope_theta=10000.0, mtp_depth=1,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1),
    groups=(LayerGroup(3, (Block("mla", "mlp"),)),
            LayerGroup(58, (Block("mla", "moe"),))),
)

SMOKE = ArchConfig(
    name="deepseek-v3-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, mtp_depth=1,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                  num_shared_experts=1),
    groups=(LayerGroup(1, (Block("mla", "mlp"),)),
            LayerGroup(2, (Block("mla", "moe"),))),
)
