"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048; 4 EnCodec
codebooks (embeddings summed, 4 output heads; the delay-pattern
interleaving and the EnCodec encoder are data-pipeline stubs per the
assignment).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    num_codebooks=4,
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, num_codebooks=2, dtype="float32",
    )
