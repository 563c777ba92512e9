"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=128, num_experts=4, experts_per_token=2, moe_d_ff=32,
        dtype="float32",
    )
