"""StableLM 2 1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]: 24L,
d=2048, 32H (MHA kv=32), d_ff=5632, vocab 100352.

(Upstream uses partial rotary (25%) and LayerNorm; we apply full rotary and
RMSNorm — structural cost identical.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    q_chunk=16, kv_chunk=16,
)
