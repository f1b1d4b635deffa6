"""qwen2-7b [arXiv:2407.10671]. 28L d=3584 28H kv=4 ff=18944 vocab=152064,
QKV bias."""
from repro_torch.configs.base import ArchConfig, Block, LayerGroup, pad_vocab

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=pad_vocab(152064), qkv_bias=True,
    rope_theta=1000000.0,
    groups=(LayerGroup(28, (Block("attn", "mlp"),)),),
)

SMOKE = ArchConfig(
    name="qwen2-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, qkv_bias=True,
    groups=(LayerGroup(2, (Block("attn", "mlp"),)),),
)
