"""Model configuration shared by every architecture in the zoo.

A copy of the reference's ``ModelConfig`` with ``torch_dtype`` in place
of ``jnp_dtype``; every field and count is unchanged."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # -- attention pattern -------------------------------------------------
    #: sliding-window size for local layers (0 = every layer global)
    window: int = 0
    #: local:global alternation — a layer l is global iff
    #: (l % pattern_period) in global_layer_ids; empty = all global
    pattern_period: int = 1
    global_layer_ids: Tuple[int, ...] = (0,)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0      # gemma3 uses a different local base

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_capacity_factor: float = 1.25

    # -- Mamba-2 (SSD) -------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256

    # -- RG-LRU hybrid (recurrentgemma) ---------------------------------------
    #: number of recurrent blocks per attention block (0 = no recurrence)
    lru_blocks_per_attn: int = 0
    lru_width: int = 0

    # -- MLA (deepseek-v2) -----------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- modality frontends (stubs) ---------------------------------------------
    num_patches: int = 0          # vlm: precomputed CLIP patch embeddings
    num_codebooks: int = 0        # audio: EnCodec codebooks

    # -- misc ---------------------------------------------------------------
    tie_embeddings: bool = True
    dtype: str = "float32"
    remat: bool = True

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def is_global_layer(self, layer: int) -> bool:
        if self.window <= 0:
            return True
        return (layer % self.pattern_period) in self.global_layer_ids

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1) in context (SSM / hybrid with
        bounded-window attention only)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # -- parameter count (for roofline MODEL_FLOPS) -----------------------
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (self.num_codebooks or 1)
        out = 0 if self.tie_embeddings else self.vocab_size * d * (self.num_codebooks or 1)
        per_layer = 0
        if self.family == "ssm":
            din, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            per_layer = d * (2 * din + 2 * g * n + h) + din * d + d
        else:
            if self.mla:
                attn = (
                    d * self.q_lora_rank
                    + self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.num_heads * self.v_head_dim * d
                )
            else:
                attn = d * self.num_heads * self.head_dim \
                    + 2 * d * self.num_kv_heads * self.head_dim \
                    + self.num_heads * self.head_dim * d
            if self.num_experts:
                n_dense = self.first_dense_layers
                dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
                moe_ffn = (
                    (self.num_experts + self.num_shared_experts)
                    * 3 * d * self.moe_d_ff
                    + d * self.num_experts
                )
                per_layer = attn  # averaged below
                total_ffn = n_dense * dense_ffn + (L - n_dense) * moe_ffn
                return emb + out + L * attn + total_ffn + 2 * L * d
            ffn = 3 * d * self.d_ff
            if self.family == "hybrid" and self.lru_blocks_per_attn:
                # mix of attention and LRU blocks
                k = self.lru_blocks_per_attn
                n_lru = (L * k) // (k + 1)
                n_att = L - n_lru
                w = self.lru_width or d
                lru = d * 2 * w + w * d + 2 * w * 4  # in/out proj + gates (conv folded)
                return emb + out + n_att * (attn + ffn) + n_lru * (lru + ffn) + 2 * L * d
            per_layer = attn + ffn
        return emb + out + L * per_layer + 2 * L * d

    def active_param_count(self) -> int:
        """MoE: params touched per token (6*N_active*D convention)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        if self.mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.num_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.num_heads * self.head_dim \
                + 2 * d * self.num_kv_heads * self.head_dim \
                + self.num_heads * self.head_dim * d
        n_dense = self.first_dense_layers
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        active_ffn = (
            (self.experts_per_token + self.num_shared_experts) * 3 * d * self.moe_d_ff
        )
        return (
            emb + L * attn + n_dense * dense_ffn
            + (L - n_dense) * active_ffn + 2 * L * d
        )
