"""DeepSeek-V2 236B [arXiv:2405.04434; hf]: 60L, d=5120, 128H MLA
(kv_lora=512, q_lora=1536, nope 128 / rope 64 / v 128), 160 routed experts
top-6 + 2 shared, expert d_ff=1536, vocab 102400.

Deviation: layer 0 is MoE here (upstream uses a dense
first layer) so the layer stack stays uniform for scan.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400,
    attn_kind="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_group=512,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=48, vocab_size=256,
    attn_kind="mla",
    q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16,
    n_experts=8, n_shared_experts=1, top_k=2, moe_group=64,
    q_chunk=16, kv_chunk=16,
)
