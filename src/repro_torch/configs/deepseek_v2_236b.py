"""deepseek-v2-236b [moe] — MLA + 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d_model=5120 128H, MLA kv_lora=512 q_lora=1536 nope/rope 128/64
v=128; expert d_ff=1536; first layer dense (d_ff 12288);
vocab=102400.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,                 # qk_nope + qk_rope
    d_ff=12288,                   # the leading dense layer
    vocab_size=102400,
    num_experts=160,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_dense_layers=1,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    tie_embeddings=False,
    dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=3, d_model=64, num_heads=4, head_dim=24, d_ff=128,
        vocab_size=128, num_experts=4, experts_per_token=2,
        num_shared_experts=1, moe_d_ff=32,
        kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, dtype="float32",
    )
