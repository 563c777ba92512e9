"""Decoder LM for every arch of the zoo: the dense and MoE attention
stacks (GQA or MLA attention, leading dense layers, shared experts), the
Mamba-2 and RG-LRU hybrid stacks, and the codebook (musicgen) and
patch-embedding (phi-3-vision) frontends: ``init_params`` and ``LM`` with
``embed`` / ``backbone`` / ``loss`` / ``logits_last`` / ``init_cache`` /
``prefill`` / ``decode_step``, and ``train_step_fn``.

Parameters are a nested dict of *stacked* per-layer tensors ``(L,
...)``, the reference's layout, so a parameter tree converts leaf for
leaf (:mod:`repro_torch.models.convert`).  The reference's ``lax.scan``
over layers is a Python loop over those stacks; the caches are
written in place, one layer view at a time.

Training (``loss``, ``backbone(train=True)``) runs every stack: the
layers run under ``torch.utils.checkpoint`` when ``cfg.remat`` (the
reference's ``jax.checkpoint``), in groups of ~sqrt(L) as well when
``sqrt_remat`` is set (its ``_grouped_scan``).  Autograd goes through the
kernels' backwards: attention's, ``moe_gmm``'s, ``ssd_intra_chunk``'s and
``rglru_scan``'s (``kernels/ops.py``).

On a mesh (DTensor parameters, ``training/trainer.py`` and
``launch/dryrun.py``) the activations carry the reference's constraints
(:func:`~repro_torch.models.common.ashard`): the embeddings
batch-sharded, each layer's residual input sequence-sharded over
'model' when it holds more than one token, and the kernels run on local
shards (``kernels/ops.py``).  The loss comes back as a plain scalar.

Modality frontends are stubs, as in the reference: phi-3-vision takes
precomputed patch embeddings put in front of the tokens; musicgen takes
``(B, K, S)`` codebook tokens (K embeddings summed, K output heads).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..distribution.sharding import BATCH_AXES, ashard
from .attention import attn_apply, attn_init
from .common import chunked_xent, dense_init, gated_mlp, gated_mlp_init, rms_norm
from .config import ModelConfig
from .mamba2 import init_ssm_state, mamba_apply, mamba_init
from .mla import init_mla_cache, mla_apply, mla_init
from .moe import moe_apply, moe_init
from .rglru import init_lru_state, rglru_apply, rglru_init

__all__ = ["LM", "init_params", "train_step_fn"]


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


def _unstack(tree, n: int) -> List:
    """The ``n`` layers of a stacked parameter tree (views, no copies),
    each leaf split once by ``unbind(0)``.  Under autograd the backward gathers the layers'
    gradients with one ``stack`` per leaf, where indexing each layer
    would write a zero-filled ``(L, ...)`` copy per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


def _norm_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A block's normed input, its sequence gathered on a mesh before the
    column-parallel projections (Megatron's sequence parallelism: the
    residual stays sequence-sharded, the projections see whole rows)."""
    return ashard(rms_norm(x, w), BATCH_AXES, None, None)


def _mixed(out: torch.Tensor) -> torch.Tensor:
    """A mixing layer's (attention's, SSM's, RG-LRU's) row-parallel output
    reduced to whole rows before the residual add, as the MLP's is
    (``gated_mlp``), so its gradient comes back whole too."""
    return ashard(out, BATCH_AXES, None, None)


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


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
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    d, L, dt = cfg.d_model, cfg.num_layers, cfg.torch_dtype
    # embed rows ~ N(0, 1/d): unit-variance inputs after the sqrt(d)
    # input scaling and O(1) logits through the tied output head
    emb_shape = ((cfg.num_codebooks,) if cfg.num_codebooks else ()) + (cfg.vocab_size, d)
    params: Dict[str, Any] = {
        "embed": dense_init(generator, emb_shape, dt, scale=d ** -0.5, device=dev),
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
    attn = mla_init if cfg.mla else attn_init

    def block(n, moe):
        layers = {
            "ln1": torch.ones((n, d), dtype=dt, device=dev),
            "ln2": torch.ones((n, d), dtype=dt, device=dev),
            "attn": attn(generator, cfg, device=dev, stack=n),
        }
        if moe:
            layers["moe"] = moe_init(generator, cfg, device=dev, stack=n)
        else:
            layers["mlp"] = gated_mlp_init(generator, d, cfg.d_ff, dt, device=dev, stack=n)
        return layers

    n_dense = _n_dense(cfg)
    if n_dense:
        params["dense_layers"] = block(n_dense, moe=False)
    params["layers"] = block(L - n_dense, moe=bool(cfg.num_experts))
    return params


def _n_dense(cfg: ModelConfig) -> int:
    """Leading dense layers before the MoE layers (deepseek-v2's first)."""
    return cfg.first_dense_layers if cfg.num_experts else 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LM:
    cfg: ModelConfig

    # -- embedding front ----------------------------------------------------
    def embed(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Token embeddings times sqrt(d): codebook tokens ``(B, K, S)``
        sum their K embeddings; ``patch_embeds`` (B, P, D), when the
        config has patches and the batch holds them, go in front."""
        cfg = self.cfg
        emb, toks = params["embed"], batch["tokens"]
        scale = math.sqrt(cfg.d_model)
        if cfg.num_codebooks:
            if toks.dim() != 3 or toks.shape[1] != cfg.num_codebooks:
                # the serving engine feeds (B, S) tokens (ROADMAP C14)
                raise ValueError(
                    f"{cfg.name} takes (B, {cfg.num_codebooks}, S) codebook tokens, "
                    f"got {tuple(toks.shape)}"
                )
            x = sum(F.embedding(toks[:, k], emb[k])
                    for k in range(cfg.num_codebooks)) * scale
        else:
            x = F.embedding(toks, emb) * scale
        if cfg.num_patches and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        return ashard(x, BATCH_AXES, None, None)

    # -- backbone ------------------------------------------------------------
    def backbone(self, params, x: torch.Tensor, *, positions: torch.Tensor,
                 cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
                 train: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
        """``train`` (no cache) remats the layers as ``cfg.remat`` says."""
        if train and cache is not None:
            raise ValueError("backbone(train=True) takes no cache")
        if self.cfg.family == "ssm":
            x, cache = self._ssm_stack(params, x, cache, train)
        elif self.cfg.family == "hybrid":
            x, cache = self._hybrid_stack(params, x, positions, cache, cache_pos, train)
        else:
            x, cache = self._attn_stack(params, x, positions, cache, cache_pos, train)
        return rms_norm(x, params["final_norm"]), cache

    def _attn_stack(self, params, x, positions, cache, cache_pos, train=False):
        """The leading dense layers (cache entries ``k0`` / ``v0``), then
        the stacked layers (``k`` / ``v``, or ``c_kv`` / ``k_rope`` for
        MLA)."""
        cfg = self.cfg
        windows, thetas = _layer_windows(cfg), _layer_thetas(cfg)
        n_dense = _n_dense(cfg)
        layers = (_unstack(params["dense_layers"], n_dense) if n_dense else []) + \
            _unstack(params["layers"], cfg.num_layers - n_dense)
        kk, vv = ("c_kv", "k_rope") if cfg.mla else ("k", "v")

        def block(x, i):
            # sequence-parallel residual carry: the remat-saved per-layer
            # activations (and their grads) shard over 'model'
            if x.shape[1] > 1:
                x = ashard(x, BATCH_AXES, "model", None)
            layer = layers[i]
            c = None
            if cache is not None:
                c = ((cache["k0"][i], cache["v0"][i]) if i < n_dense
                     else (cache[kk][i - n_dense], cache[vv][i - n_dense]))
            h = _norm_in(x, layer["ln1"])
            if cfg.mla:
                out, _ = mla_apply(layer["attn"], h, cfg, positions=positions, cache=c,
                                   cache_pos=cache_pos)
            else:
                out, _ = attn_apply(
                    layer["attn"], h, cfg, positions=positions,
                    window=int(windows[i]), theta=float(thetas[i]), cache=c,
                    cache_pos=cache_pos,
                )
            x = x + _mixed(out)
            h = _norm_in(x, layer["ln2"])
            return x + (moe_apply(layer["moe"], h, cfg) if "moe" in layer
                        else gated_mlp(layer["mlp"], h))

        if train:
            return self._train_layers(block, x, cfg.num_layers), cache
        for i in range(cfg.num_layers):
            x = block(x, i)
        return x, cache

    def _train_layers(self, block, x, n_layers: int):
        """``block(x, i)`` for each layer in order, each under
        ``torch.utils.checkpoint`` when ``cfg.remat``.  With ``sqrt_remat``
        (and remat, L >= 8) groups of g = int(sqrt(L)) layers are also
        checkpointed as a whole, the rest run flat: the reference's
        ``_grouped_scan``."""
        remat = self.cfg.remat

        def layer(x, i):
            return _ckpt(block, x, i) if remat else block(x, i)

        g = int(math.sqrt(n_layers)) if remat and getattr(self.cfg, "sqrt_remat", False) else 0
        if g < 2 or n_layers < 8:
            for i in range(n_layers):
                x = layer(x, i)
            return x

        def group(x, first):
            for i in range(first, first + g):
                x = layer(x, i)
            return x

        n_groups = n_layers // g
        for gi in range(n_groups):
            x = _ckpt(group, x, gi * g)
        for i in range(n_groups * g, n_layers):
            x = layer(x, i)
        return x

    def _ssm_stack(self, params, x, cache, train=False):
        """Mamba-2 layers.  A decode step's state is float32 (the
        reference's ``_ssm_step`` returns it so, and its layer scan stacks
        it), so the cache's SSM planes turn float32 at the first decode
        step and stay so, as the reference's do."""
        if cache is not None and x.shape[1] == 1 and cache["ssm"].dtype != torch.float32:
            cache["ssm"] = cache["ssm"].float()
        layers = _unstack(params["layers"], self.cfg.num_layers)

        def block(x, i):
            if x.shape[1] > 1:
                x = ashard(x, BATCH_AXES, "model", None)
            state = None if cache is None else {"ssm": cache["ssm"][i],
                                                "conv": cache["conv"][i]}
            out, new = mamba_apply(layers[i]["mamba"], _norm_in(x, layers[i]["norm"]),
                                   self.cfg, state=state)
            if cache is not None:
                cache["ssm"][i] = new["ssm"]
                cache["conv"][i] = new["conv"]
            return x + _mixed(out)

        if train:
            return self._train_layers(block, x, self.cfg.num_layers), cache
        for i in range(self.cfg.num_layers):
            x = block(x, i)
        return x, cache

    def _hybrid_stack(self, params, x, positions, cache, cache_pos, train=False):
        """Units of ``k`` RG-LRU blocks and one local-attention block on
        the ring cache, then the pattern's trailing RG-LRU blocks.  In
        training each block is one layer of ``_train_layers`` (the
        reference remats per unit: the same numbers)."""
        cfg = self.cfg
        k = cfg.lru_blocks_per_attn
        n_lru, n_att = _hybrid_layout(cfg)
        order = []
        for u in range(n_att):
            order += [("lru", u * k + j) for j in range(k)] + [("attn", u)]
        order += [("lru", i) for i in range(n_att * k, n_lru)]
        stacks = {"lru": _unstack(params["lru_layers"], n_lru),
                  "attn": _unstack(params["attn_layers"], n_att)}

        def block(x, j):
            kind, i = order[j]
            layer = stacks[kind][i]
            if x.shape[1] > 1 and j < n_att * (k + 1) and j % (k + 1) == 0:
                x = ashard(x, BATCH_AXES, "model", None)   # each unit's input
            if kind == "lru":
                state = None if cache is None else {"h": cache["h"][i],
                                                    "conv": cache["conv"][i]}
                out, new = rglru_apply(layer["lru"], _norm_in(x, layer["ln1"]), cfg, state)
                if cache is not None:
                    cache["h"][i] = new["h"]
                    cache["conv"][i] = new["conv"]
            else:
                out, _ = attn_apply(
                    layer["attn"], _norm_in(x, layer["ln1"]), cfg, positions=positions,
                    window=cfg.window, theta=cfg.rope_theta,
                    cache=(cache["k"][i], cache["v"][i]) if cache is not None else None,
                    cache_pos=cache_pos, ring=True,
                )
            x = x + _mixed(out)
            return x + gated_mlp(layer["mlp"], _norm_in(x, layer["ln2"]))

        if train:
            return self._train_layers(block, x, len(order)), cache
        for j in range(len(order)):
            x = block(x, j)
        return x, cache

    # -- heads ---------------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy (a label of -1 carries no loss),
        the layers in train mode.  ``labels`` are (B, S), or (B, K, S) for
        codebooks, whose K losses are averaged; patch positions carry no
        loss."""
        cfg = self.cfg
        x = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self.backbone(params, x, positions=positions, train=True)
        labels = batch["labels"]
        if cfg.num_codebooks:
            losses = [chunked_xent(x, params["embed"][k], labels[:, k],
                                   softcap=cfg.final_logit_softcap)
                      for k in range(cfg.num_codebooks)]
            return _whole(sum(losses) / cfg.num_codebooks)
        if cfg.num_patches and "patch_embeds" in batch:
            pad = torch.full((labels.shape[0], cfg.num_patches), -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        return _whole(chunked_xent(x, params["embed"], labels,
                                   softcap=cfg.final_logit_softcap))

    def logits_last(self, params, x_last: torch.Tensor) -> torch.Tensor:
        """(B, D) -> (B, V), or (B, K, V) for codebooks."""
        emb = params["embed"]
        if self.cfg.num_codebooks and isinstance(emb, DTensor):   # one product per codebook
            out = torch.stack([torch.matmul(x_last, emb[k].t())
                               for k in range(self.cfg.num_codebooks)], dim=1)
        elif self.cfg.num_codebooks:
            out = torch.einsum("bd,kvd->bkv", x_last, emb)
        else:
            out = torch.matmul(x_last, emb.t())
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
        n_dense = _n_dense(cfg)
        if cfg.mla:
            cache = init_mla_cache(cfg, batch, max_len, cfg.num_layers - n_dense, dev)
            if n_dense:
                # the leading dense layers use MLA too: their latent and
                # rope key, under the reference's names
                dense = init_mla_cache(cfg, batch, max_len, n_dense, dev)
                cache["k0"], cache["v0"] = dense["c_kv"], dense["k_rope"]
            return cache
        shape = (cfg.num_layers - n_dense, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
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


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A mesh's loss as a plain tensor (every rank holds the same)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# functional entry points
# ---------------------------------------------------------------------------
def train_step_fn(cfg: ModelConfig):
    """``loss_fn(params, batch)``: the scalar that a train step
    differentiates (the reference's ``train_step_fn``)."""
    model = LM(cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch)

    return loss_fn
