"""gemma3-4b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-*-pt].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; head_dim=256;
window 1024 on local layers; rope base 1M global / 10k local.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    window=1024,
    pattern_period=6,
    global_layer_ids=(5,),        # 5 local then 1 global
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    attn_logit_softcap=0.0,
    final_logit_softcap=0.0,
    tie_embeddings=True,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, window=8, dtype="float32",
    )
