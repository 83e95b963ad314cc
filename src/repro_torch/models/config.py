"""Model configuration covering the 10 assigned architectures.

The port's copy of ``repro.models.config``: every field and property."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavour
    attn_kind: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False           # qwen3
    attn_softcap: float = 0.0       # gemma2
    logit_softcap: float = 0.0      # gemma2
    sliding_window: int = 0         # 0 = full attention
    global_every: int = 0           # gemma2: every k-th layer is global
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_group: int = 512            # tokens per dispatch group
    capacity_factor: float = 1.25
    moe_impl: str = "onehot"        # onehot | ragged (perf path)
    moe_combine_dtype: str = "float32"  # bfloat16 halves dispatch bytes

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    ssm_compute_dtype: str = "float32"  # bfloat16 halves SSD scan bytes

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_len: int = 1500         # stub audio frames after conv frontend

    # vlm (internvl)
    vision_len: int = 0             # stub patch embeddings prepended

    act: str = "silu"               # silu | gelu
    norm_eps: float = 1e-6
    post_norms: bool = False        # gemma2 post-block norms
    scale_embed: bool = False       # gemma2 sqrt(d) embedding scale
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_to: int = 256

    # attention compute chunking (the plain chunked attention)
    q_chunk: int = 512
    kv_chunk: int = 1024
    # serving: keep FSDP sharding of params (True) or TP-only replication
    # across data (False — kills per-layer all-gathers at inference)
    serve_fsdp_params: bool = True

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def padded_vocab(self) -> int:
        v, p = self.vocab_size, self.vocab_pad_to
        return ((v + p - 1) // p) * p

    @property
    def uses_attention(self) -> bool:
        return self.attn_kind != "none"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def bounded_kv(self) -> bool:
        """True if the decode cache does not grow with context (SSM) or is
        window-bounded (pure sliding-window attention)."""
        if self.family == "ssm":
            return True
        return self.sliding_window > 0 and self.global_every == 0

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
