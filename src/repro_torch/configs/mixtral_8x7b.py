"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L, d=4096, 32H (GQA kv=8),
expert d_ff=14336, vocab 32000, 8 experts top-2, sliding-window attention."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, moe_group=256,
    sliding_window=4096, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    n_experts=4, top_k=2, moe_group=64,
    sliding_window=8, rope_theta=1e6,
    q_chunk=16, kv_chunk=16,
)
