"""h2o-danube-1.8b [arXiv:2401.16818]. 24L d=2560 32H kv=8 ff=6912
vocab=32000, llama+mistral mix with sliding-window attention (4096)."""
from repro_torch.configs.base import ArchConfig, Block, LayerGroup, pad_vocab

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=pad_vocab(32000), sliding_window=4096,
    rope_theta=10000.0,
    groups=(LayerGroup(24, (Block("attn", "mlp"),)),),
)

SMOKE = ArchConfig(
    name="danube-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, sliding_window=16,
    groups=(LayerGroup(2, (Block("attn", "mlp"),)),),
)
