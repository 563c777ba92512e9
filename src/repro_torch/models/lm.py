"""Decoder LM for the dense, MoE, Mamba-2 and RG-LRU hybrid stacks: ``init_params``
and ``LM`` with ``embed`` / ``backbone`` / ``logits_last`` /
``init_cache`` / ``prefill`` / ``decode_step``.

Parameters are a nested dict of *stacked* per-layer tensors ``(L,
...)``, the reference's layout, so a parameter tree converts leaf for
leaf (:mod:`repro_torch.models.convert`).  The reference's ``lax.scan``
over layers is a Python loop over those stacks; the caches are
written in place, one layer view at a time.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: MLA and leading dense layers (A9), the codebook and patch
frontends (A9), and the training loss (A10).
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
from .mamba2 import init_ssm_state, mamba_apply, mamba_init
from .moe import moe_apply, moe_init
from .rglru import init_lru_state, rglru_apply, rglru_init

__all__ = ["LM", "init_params", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a
    config whose stack the port does not carry yet."""
    if cfg.mla:
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


def _hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(#lru layers, #attention layers) for the 1:k hybrid pattern."""
    k = cfg.lru_blocks_per_attn
    n_units = cfg.num_layers // (k + 1)
    rem = cfg.num_layers - n_units * (k + 1)   # trailing lru blocks
    return n_units * k + rem, n_units


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
    if cfg.family == "ssm":
        params["layers"] = {
            "norm": torch.ones((L, d), dtype=dt, device=dev),
            "mamba": mamba_init(generator, cfg, device=dev, stack=L),
        }
        return params
    if cfg.family == "hybrid":
        n_lru, n_att = _hybrid_layout(cfg)
        for key, n, core, init in (("lru_layers", n_lru, "lru", rglru_init),
                                   ("attn_layers", n_att, "attn", attn_init)):
            params[key] = {
                "ln1": torch.ones((n, d), dtype=dt, device=dev),
                "ln2": torch.ones((n, d), dtype=dt, device=dev),
                core: init(generator, cfg, device=dev, stack=n),
                "mlp": gated_mlp_init(generator, d, cfg.d_ff, dt, device=dev, stack=n),
            }
        return params
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
        if self.cfg.family == "ssm":
            x, cache = self._ssm_stack(params, x, cache)
        elif self.cfg.family == "hybrid":
            x, cache = self._hybrid_stack(params, x, positions, cache, cache_pos)
        else:
            x, cache = self._attn_stack(params, x, positions, cache, cache_pos)
        return rms_norm(x, params["final_norm"]), cache

    def _attn_stack(self, params, x, positions, cache, cache_pos):
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
        return x, cache

    def _ssm_stack(self, params, x, cache):
        """Mamba-2 layers.  A decode step's state is float32 (the
        reference's ``_ssm_step`` returns it so, and its layer scan stacks
        it), so the cache's SSM planes turn float32 at the first decode
        step and stay so, as the reference's do."""
        if cache is not None and x.shape[1] == 1 and cache["ssm"].dtype != torch.float32:
            cache["ssm"] = cache["ssm"].float()
        for i in range(self.cfg.num_layers):
            layer = _take(params["layers"], i)
            h = rms_norm(x, layer["norm"])
            state = None if cache is None else {"ssm": cache["ssm"][i],
                                                "conv": cache["conv"][i]}
            out, new = mamba_apply(layer["mamba"], h, self.cfg, state=state)
            if cache is not None:
                cache["ssm"][i] = new["ssm"]
                cache["conv"][i] = new["conv"]
            x = x + out
        return x, cache

    def _hybrid_stack(self, params, x, positions, cache, cache_pos):
        """Units of ``k`` RG-LRU blocks and one local-attention block on
        the ring cache, then the pattern's trailing RG-LRU blocks."""
        cfg = self.cfg
        k = cfg.lru_blocks_per_attn
        n_lru, n_att = _hybrid_layout(cfg)
        order = []
        for u in range(n_att):
            order += [("lru", u * k + j) for j in range(k)] + [("attn", u)]
        order += [("lru", i) for i in range(n_att * k, n_lru)]
        for kind, i in order:
            if kind == "lru":
                layer = _take(params["lru_layers"], i)
                state = None if cache is None else {"h": cache["h"][i],
                                                    "conv": cache["conv"][i]}
                out, new = rglru_apply(layer["lru"], rms_norm(x, layer["ln1"]), cfg, state)
                if cache is not None:
                    cache["h"][i] = new["h"]
                    cache["conv"][i] = new["conv"]
            else:
                layer = _take(params["attn_layers"], i)
                out, _ = attn_apply(
                    layer["attn"], rms_norm(x, layer["ln1"]), cfg, positions=positions,
                    window=cfg.window, theta=cfg.rope_theta,
                    cache=(cache["k"][i], cache["v"][i]) if cache is not None else None,
                    cache_pos=cache_pos, ring=True,
                )
            x = x + out
            x = x + gated_mlp(layer["mlp"], rms_norm(x, layer["ln2"]))
        return x, cache

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
        dev = resolve_device(device)
        if cfg.family == "ssm":
            return init_ssm_state(cfg, batch, cfg.num_layers, dev)
        if cfg.family == "hybrid":
            n_lru, n_att = _hybrid_layout(cfg)
            win = min(max_len, cfg.window) if cfg.window else max_len
            shape = (n_att, batch, cfg.num_kv_heads, win, cfg.head_dim)
            return {**init_lru_state(cfg, batch, n_lru, dev),
                    "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
                    "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
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
