"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUB
[hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.  The CLIP
vision tower is a stub per the assignment: ``input_specs()`` provides
precomputed patch embeddings (576 patches) prepended to the token
embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, num_patches=16, dtype="float32",
    )
