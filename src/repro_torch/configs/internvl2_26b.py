"""internvl2-26b [arXiv:2404.16821]. InternLM2-20B backbone: 48L d=6144
48H kv=8 ff=16384 vocab=92553 (padded ->92672). InternViT frontend is a
STUB: input_specs provides precomputed patch embeddings (1024 tokens)."""
from repro_torch.configs.base import ArchConfig, Block, LayerGroup, pad_vocab

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=pad_vocab(92553),
    rope_theta=1000000.0, frontend="vision", num_frontend_tokens=1024,
    groups=(LayerGroup(48, (Block("attn", "mlp"),)),),
)

SMOKE = ArchConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, frontend="vision", num_frontend_tokens=8,
    groups=(LayerGroup(2, (Block("attn", "mlp"),)),),
)
