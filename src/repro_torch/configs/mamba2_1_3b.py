"""Mamba2 1.3B [arXiv:2405.21060; unverified]: 48L, d=2048, attention-free
SSD, d_inner=4096 (expand 2), 64 ssm heads x headdim 64, state 128,
vocab 50280."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    attn_kind="none",
    ssm_state=128, ssm_heads=64, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=256,
    attn_kind="none",
    ssm_state=16, ssm_heads=8, ssm_expand=2, ssm_chunk=8,
    tie_embeddings=True,
)
