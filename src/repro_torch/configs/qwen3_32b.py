"""qwen3-32b [hf:Qwen/Qwen3-8B family]. 64L d=5120 64H kv=8 ff=25600
vocab=151936, qk_norm, head_dim=128."""
from repro_torch.configs.base import ArchConfig, Block, LayerGroup, pad_vocab

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=pad_vocab(151936), qk_norm=True, head_dim=128,
    rope_theta=1000000.0,
    groups=(LayerGroup(64, (Block("attn", "mlp"),)),),
)

SMOKE = ArchConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, qk_norm=True, head_dim=16,
    groups=(LayerGroup(2, (Block("attn", "mlp"),)),),
)
