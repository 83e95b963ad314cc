"""Hymba 1.5B [arXiv:2411.13676; hf]: 32L, d=1600, 25H (GQA kv=5),
d_ff=5504, vocab 32001, parallel attention + mamba heads, ssm_state=16.

(Meta tokens and the mixed global/local schedule are simplified to uniform
sliding-window attention.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    sliding_window=1024,
    ssm_state=16, ssm_heads=50, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    sliding_window=8,
    ssm_state=8, ssm_heads=8, ssm_expand=2, ssm_chunk=8,
    q_chunk=16, kv_chunk=16,
)
