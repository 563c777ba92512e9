"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
expand=2 => d_inner=5120; headdim=64 => 80 SSD heads; 1 B/C group.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    ssd_chunk=256,
    tie_embeddings=True,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, vocab_size=128,
        ssm_state=16, ssm_head_dim=16, ssd_chunk=16,
        dtype="float32",
    )
