"""qwen2-1.5b [arXiv:2407.10671]. 28L d=1536 12H kv=2 ff=8960 vocab=151936,
QKV bias, tied embeddings."""
from repro_torch.configs.base import ArchConfig, Block, LayerGroup, pad_vocab

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=pad_vocab(151936), qkv_bias=True,
    rope_theta=1000000.0, tie_embeddings=True,
    groups=(LayerGroup(28, (Block("attn", "mlp"),)),),
)

SMOKE = ArchConfig(
    name="qwen2-1.5b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, qkv_bias=True, tie_embeddings=True,
    groups=(LayerGroup(2, (Block("attn", "mlp"),)),),
)
