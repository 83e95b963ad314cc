"""Qwen3 0.6B [hf:Qwen/Qwen3-0.6B family; hf]: 28L, d=1024, 16H (GQA kv=8),
d_ff=3072, vocab 151936, qk_norm, head_dim 128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=256,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    q_chunk=16, kv_chunk=16,
)
