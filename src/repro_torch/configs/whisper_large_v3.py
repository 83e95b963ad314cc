"""Whisper large-v3 [arXiv:2212.04356; unverified]: enc-dec, 32 encoder +
32 decoder layers, d=1280, 20H MHA, d_ff=5120, vocab 51866. The conv audio
frontend is a STUB (input_specs provides 1500 frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_len=1500,
    act="gelu",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    encoder_layers=2, encoder_len=24,
    act="gelu", q_chunk=16, kv_chunk=16,
)
