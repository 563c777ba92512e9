"""Decoder LM for the dense and MoE attention stacks: ``init_params``
and ``LM`` with ``embed`` / ``backbone`` / ``logits_last`` /
``init_cache`` / ``prefill`` / ``decode_step``.

Parameters are a nested dict of *stacked* per-layer tensors ``(L,
...)``, the reference's layout, so a parameter tree converts leaf for
leaf (:mod:`repro_torch.models.convert`).  The reference's ``lax.scan``
over layers is a Python loop over those stacks; the KV cache is
written in place, one layer view at a time.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the Mamba-2 stack (B3), the RG-LRU hybrid stack (B4), MLA and
leading dense layers (A9), the codebook and patch frontends (A9), and
the training loss (A10).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .attention import attn_apply, attn_init
from .common import dense_init, gated_mlp, gated_mlp_init, rms_norm
from .config import ModelConfig
from .moe import moe_apply, moe_init

__all__ = ["LM", "init_params", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a
    config whose stack the port does not carry yet."""
    if cfg.family == "ssm":
        item = "B3 (mamba2_2p7b serving with the SSD kernel)"
    elif cfg.family == "hybrid":
        item = "B4 (recurrentgemma_9b serving with the RG-LRU kernel and ring cache)"
    elif cfg.mla:
        item = "A9 (MLA attention, deepseek_v2_236b)"
    elif cfg.num_experts and (cfg.first_dense_layers or cfg.num_shared_experts):
        item = "A9 (leading dense layers and shared experts, deepseek_v2_236b)"
    elif cfg.num_codebooks:
        item = "A9 (codebook frontend, musicgen_large)"
    elif cfg.num_patches:
        item = "A9 (patch-embedding frontend, phi3_vision_4p2b)"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} stack is not ported yet: ROADMAP {item}"
    )


# ---------------------------------------------------------------------------
# per-layer pattern tables
# ---------------------------------------------------------------------------
def _layer_windows(cfg: ModelConfig) -> np.ndarray:
    return np.asarray(
        [0 if cfg.is_global_layer(i) else cfg.window for i in range(cfg.num_layers)],
        np.int32,
    )


def _layer_thetas(cfg: ModelConfig) -> np.ndarray:
    local = cfg.rope_theta_local or cfg.rope_theta
    return np.asarray(
        [cfg.rope_theta if cfg.is_global_layer(i) else local
         for i in range(cfg.num_layers)],
        np.float32,
    )


def _take(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random parameters on ``device`` (``"meta"`` makes shapes and
    dtypes only), drawn from ``generator`` (default: seed 0 on
    ``device``).  Same tree, shapes, dtypes and scales as the
    reference's ``init_params``; other numbers, since the generators
    differ."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    d, L, dt = cfg.d_model, cfg.num_layers, cfg.torch_dtype
    # embed rows ~ N(0, 1/d): unit-variance inputs after the sqrt(d)
    # input scaling and O(1) logits through the tied output head
    params: Dict[str, Any] = {
        "embed": dense_init(generator, (cfg.vocab_size, d), dt, scale=d ** -0.5,
                            device=dev),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
    }
    layers = {
        "ln1": torch.ones((L, d), dtype=dt, device=dev),
        "ln2": torch.ones((L, d), dtype=dt, device=dev),
        "attn": attn_init(generator, cfg, device=dev, stack=L),
    }
    if cfg.num_experts:
        layers["moe"] = moe_init(generator, cfg, device=dev, stack=L)
    else:
        layers["mlp"] = gated_mlp_init(generator, d, cfg.d_ff, dt, device=dev, stack=L)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LM:
    cfg: ModelConfig

    def __post_init__(self):
        check_supported(self.cfg)

    # -- embedding front ----------------------------------------------------
    def embed(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return params["embed"][batch["tokens"]] * math.sqrt(self.cfg.d_model)

    # -- backbone ------------------------------------------------------------
    def backbone(self, params, x: torch.Tensor, *, positions: torch.Tensor,
                 cache: Optional[Dict] = None, cache_pos: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        windows, thetas = _layer_windows(cfg), _layer_thetas(cfg)
        moe = bool(cfg.num_experts)
        for i in range(cfg.num_layers):
            layer = _take(params["layers"], i)
            h = rms_norm(x, layer["ln1"])
            out, _ = attn_apply(
                layer["attn"], h, cfg, positions=positions,
                window=int(windows[i]), theta=float(thetas[i]),
                cache=(cache["k"][i], cache["v"][i]) if cache is not None else None,
                cache_pos=cache_pos,
            )
            x = x + out
            h = rms_norm(x, layer["ln2"])
            x = x + (moe_apply(layer["moe"], h, cfg) if moe else gated_mlp(layer["mlp"], h))
        return rms_norm(x, params["final_norm"]), cache

    # -- heads ---------------------------------------------------------------
    def logits_last(self, params, x_last: torch.Tensor) -> torch.Tensor:
        """(B, D) -> (B, V)."""
        out = torch.matmul(x_last, params["embed"].t())
        cap = self.cfg.final_logit_softcap
        if cap:
            out = cap * torch.tanh(out / cap)
        return out

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        dev = resolve_device(device)
        return {
            "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
        }

    def prefill(self, params, batch, cache) -> Tuple[torch.Tensor, Dict]:
        x = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, cache = self.backbone(params, x, positions=positions, cache=cache, cache_pos=0)
        return self.logits_last(params, x[:, -1]), cache

    def decode_step(self, params, batch, cache, pos: int) -> Tuple[torch.Tensor, Dict]:
        """One new token against an existing cache filled to ``pos``."""
        x = self.embed(params, batch)
        positions = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)
        x, cache = self.backbone(params, x, positions=positions, cache=cache,
                                 cache_pos=int(pos))
        return self.logits_last(params, x[:, -1]), cache
