"""InternVL2 2B [arXiv:2404.16821; hf]: InternLM2-1.8B backbone — 24L,
d=2048, 16H (GQA kv=8), d_ff=8192, vocab 92553. The InternViT frontend is a
STUB: input_specs provides 256 precomputed patch embeddings prepended to
the text sequence."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553,
    vision_len=256, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    vision_len=8, q_chunk=16, kv_chunk=16,
)
