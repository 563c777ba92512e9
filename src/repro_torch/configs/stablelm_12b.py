"""stablelm-12b [dense] [hf:stabilityai/stablelm-2-12b].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352; head_dim=160;
per-head QK-norm.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    qk_norm=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, dtype="float32",
    )
