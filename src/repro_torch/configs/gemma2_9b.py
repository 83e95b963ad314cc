"""Gemma 2 9B [arXiv:2408.00118; hf]: 42L, d=3584, 16H (GQA kv=8),
d_ff=14336, vocab 256000, local(4096)/global alternating, attn softcap 50,
logit softcap 30, post-norms, sqrt(d) embedding scale, head_dim 256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    sliding_window=4096, global_every=2,
    attn_softcap=50.0, logit_softcap=30.0,
    post_norms=True, scale_embed=True, tie_embeddings=True,
    act="geglu",
)

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    sliding_window=8, global_every=2,
    attn_softcap=50.0, logit_softcap=30.0,
    post_norms=True, scale_embed=True, tie_embeddings=True,
    act="geglu", q_chunk=16, kv_chunk=16,
)
