"""gemma2-27b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; head_dim=128;
1:1 local(4096):global alternation; attn softcap 50, final softcap 30.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    window=4096,
    pattern_period=2,
    global_layer_ids=(1,),        # local, global, local, global, ...
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, window=16, dtype="float32",
    )
