"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; pattern:
(recurrent, recurrent, attention) repeating; window 2048; lru_width
4096.  head_dim 256 so 16 heads span d_model... (Griffin uses
head_dim=256 MQA).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    window=2048,
    lru_blocks_per_attn=2,
    lru_width=4096,
    conv_width=4,
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=5,   # 1 full (r,r,a) unit + 2 trailing lru blocks
        d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=128, window=8, lru_width=64, dtype="float32",
    )
