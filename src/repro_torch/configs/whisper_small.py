"""whisper-small [arXiv:2212.04356]. Encoder-decoder, 12L each, d=768 12H
ff=3072 vocab=51865 (padded ->51968), layernorm+gelu, conv frontend STUB
(input_specs provides precomputed frame embeddings)."""
from repro_torch.configs.base import ArchConfig, Block, LayerGroup, pad_vocab

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=pad_vocab(51865),
    norm="layernorm", act="gelu", qkv_bias=True,
    is_encoder_decoder=True, encoder_layers=12, encoder_seq_len=1500,
    frontend="audio",
    groups=(LayerGroup(12, (Block("attn", "mlp"),)),),
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    norm="layernorm", act="gelu", qkv_bias=True,
    is_encoder_decoder=True, encoder_layers=2, encoder_seq_len=32,
    frontend="audio",
    groups=(LayerGroup(2, (Block("attn", "mlp"),)),),
)
