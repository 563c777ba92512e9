"""Sharding rules over the ``(pod, data, model)`` production mesh, as
DTensor placements.

Parameters: tensor-parallel over ``model`` (attention heads / FFN width
/ experts / vocab), optionally FSDP over ``data`` (big archs: required
to fit deepseek-v2's 472 GB of bf16 weights), replicated over ``pod``
(gradients cross pods once per step).

Rules are path-name based and the reference's own, leaf for leaf.  A
spec is a tuple with one entry per tensor dimension: a mesh-axis name, a
tuple of names (the dimension split over several axes, outermost
first) or ``None`` (replicated), the entries of the reference's
``PartitionSpec``.  :func:`to_placements` turns a spec into ``Shard`` /
``Replicate`` placements on a :class:`~torch.distributed.device_mesh.DeviceMesh`,
after :func:`_filter_spec` has dropped the axes the mesh lacks and the
axes that do not divide the dimension.

Activations on a mesh: :func:`ashard` (the reference's activation
constraint, re-exported by ``models/common.py`` under its name) and
:func:`local_call` (``local_map``, the reference's ``shard_map``), with
which the models and ``kernels/ops.py`` run each kernel on local shards.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

if TYPE_CHECKING:
    from ..models.config import ModelConfig

__all__ = ["param_specs", "batch_specs", "cache_specs", "to_placements", "BATCH_AXES",
           "placements", "model_split", "ashard", "local_call", "conv_on_mesh"]

BATCH_AXES = ("pod", "data")

# leaf name -> role
_COL = {  # output dim is 'model' (column parallel)
    "wq", "wk", "wv", "wg", "wu", "in_proj", "in_x", "in_gate",
    "q_up", "k_up", "v_up", "w_r", "w_i", "q_down", "kv_down", "k_rope",
}
_ROW = {  # input dim is 'model' (row parallel)
    "wo", "wd", "out_proj", "out",
}
_REPL = {
    "router", "conv", "A_log", "D", "dt_bias", "lam", "norm",
    "ln1", "ln2", "final_norm", "qn", "kn", "q_norm", "kv_norm",
}

Spec = Tuple[Any, ...]


def _is_expert(path: Tuple[str, ...]) -> bool:
    return "moe" in path and "shared" not in path


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict, keeping its structure: the
    key paths the reference's ``tree_map_with_path`` names."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params: Any, fsdp: bool = True):
    """Spec tree matching ``params`` (tensors, meta tensors included).

    Handles the stacked-layer leading axis: rules are written for the
    *unstacked* leaf shape; an extra leading dim maps to ``None``.
    """

    def spec_for(names, leaf) -> Spec:
        ndim = leaf.dim()
        name = names[-1]
        fs = "data" if fsdp else None
        in_moe = _is_expert(names)
        in_shared = "shared" in names

        if name == "embed":
            if ndim == 3:
                return (None, "model", fs)
            return ("model", fs)
        if name in _REPL:
            return (None,) * ndim

        # base (unstacked) rule
        if name in _COL:
            if in_moe and not in_shared:
                base = ("model", fs, None)          # (E, d, f)
            else:
                base = (fs, "model")                # (d, f)
        elif name in _ROW:
            if in_moe and not in_shared:
                base = ("model", None, fs)          # (E, f, d)
            else:
                base = ("model", fs)                # (f, d)
        else:
            return (None,) * ndim

        extra = ndim - len(base)
        if extra < 0:  # e.g. 1-D conv kernels caught by name sets above
            return (None,) * ndim
        return (None,) * extra + base

    return _map_with_path(spec_for, params)


def batch_specs(cfg: ModelConfig, batch: Dict[str, Any]):
    out = {}
    for k, v in batch.items():
        nd = v.dim() if hasattr(v, "dim") else 0
        out[k] = () if nd == 0 else (BATCH_AXES,) + (None,) * (nd - 1)
    return out


def cache_specs(
    cfg: ModelConfig,
    cache: Dict[str, Any],
    batch_shardable: bool,
    model_size: int = 16,
):
    """Decode/prefill cache sharding.

    A 32k-context decode cache is 300-800 GB globally, so batch sharding
    alone is not enough: KV heads shard over 'model' when the head count
    divides the axis, else the *sequence* dim does (GQA archs with 4-8 KV
    heads).  With ``batch_shardable=False`` (long_500k, batch=1) state
    width/heads carry all the sharding.
    """
    out = {}
    b = BATCH_AXES if batch_shardable else None
    for k, v in cache.items():
        nd = v.dim()
        if k in ("k", "v") and nd == 5:          # (L, B, Hkv, M, hd)
            hkv, m = v.shape[2], v.shape[3]
            if hkv % model_size == 0:
                out[k] = (None, b, "model", None, None)
            elif m % model_size == 0:
                out[k] = (None, b, None, "model", None)
            else:
                out[k] = (None, b, None, None, None)
        elif k in ("c_kv", "k_rope", "k0", "v0") and nd == 4:  # (L,B,M,r)
            if v.shape[3] % model_size == 0:
                out[k] = (None, b, None, "model")
            else:
                out[k] = (None, b, "model", None)
        elif k == "ssm":                         # (L, B, H, P, N)
            out[k] = (None, b, "model", None, None)
        elif k == "h":                           # (L, B, W)
            out[k] = (None, b, "model")
        elif k == "conv":                        # (L, B, cw-1, C)
            out[k] = (None, b, None, "model")
        else:
            out[k] = (None,) * nd
    return out


# ---------------------------------------------------------------------------
# specs -> placements
# ---------------------------------------------------------------------------
def _mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a DeviceMesh or of anything with
    ``axis_names`` and a ``shape`` mapping (a JAX mesh's interface)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if hasattr(shape, "items"):
        return dict(shape)
    return dict(zip(mesh.axis_names, shape))


def _filter_spec(spec: Spec, mesh, shape: Optional[Sequence[int]] = None) -> Spec:
    """Drop axes the mesh does not have (single-pod mesh has no 'pod')
    and axes whose size does not divide the dimension (vocab 50280
    cannot shard 16-way, a batch of 1 cannot shard over 'data', gemma3's
    4 KV heads cannot split across 16 model shards); of a tuple entry the
    outermost axis goes first."""
    sizes = _mesh_sizes(mesh)
    entries = []
    for i, e in enumerate(spec):
        dim = None if shape is None or i >= len(shape) else shape[i]

        def ok(axes) -> bool:
            if dim is None:
                return True
            prod = 1
            for a in axes:
                prod *= sizes[a]
            return dim % prod == 0

        if e is None:
            entries.append(None)
        elif isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in sizes)
            while kept and not ok(kept):
                kept = kept[1:]  # drop the outermost axis first
            entries.append(kept if kept else None)
        else:
            keep = e in sizes and ok((e,))
            entries.append(e if keep else None)
    return tuple(entries)


def to_placements(spec: Spec, mesh, shape: Optional[Sequence[int]] = None) -> tuple:
    """One placement per mesh dimension: ``Shard(i)`` for the tensor dim
    ``i`` whose (filtered) entry names the axis, else ``Replicate()``.
    Axes sharing a dimension split it in mesh order, outermost first, as a
    tuple entry of the reference's ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    spec = _filter_spec(spec, mesh, shape)
    out = [Replicate() for _ in names]
    for i, e in enumerate(spec):
        axes = () if e is None else (tuple(e) if isinstance(e, (tuple, list)) else (e,))
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {e!r} splits dim {i} against the mesh order {names}")
        for p in pos:
            out[p] = Shard(i)
    return tuple(out)


# ---------------------------------------------------------------------------
# activations on a mesh
# ---------------------------------------------------------------------------
def placements(x: torch.Tensor, spec, mesh=None) -> tuple:
    """The placements of ``spec`` (one entry per dim of ``x``; ``()`` for
    all replicated) on ``mesh`` (default: ``x``'s, a DTensor's), with the
    axes the mesh lacks and the axes that do not divide their dim dropped
    (:func:`repro_torch.distribution.sharding.to_placements`)."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    return to_placements(spec, mesh if mesh is not None else x.device_mesh, x.shape)


def model_split(x: DTensor, *sizes: int) -> Optional[str]:
    """'model' when ``x``'s mesh has that axis and it divides every size
    (a dim to split over it), else None (replicated over it)."""
    m = dict(zip(x.device_mesh.mesh_dim_names, x.device_mesh.shape)).get("model")
    return "model" if m and all(n % m == 0 for n in sizes) else None


def ashard(x: torch.Tensor, *spec) -> torch.Tensor:
    """Constrain activation sharding: a DTensor is redistributed to
    ``spec``'s placements; a plain tensor (no mesh) is returned as is.
    Axes the mesh does not have are dropped, as the reference drops them;
    so are axes that do not divide their dim (DTensor's views need even
    shards, where GSPMD pads)."""
    if not isinstance(x, DTensor):
        return x
    want = placements(x, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _grad_placements(p, outs) -> Optional[tuple]:
    """The placements of the gradient of an input placed ``p`` in a call
    whose outputs are placed ``outs``: a mesh dim the input is replicated
    over while an output is sharded or partial over it contributes a
    partial gradient from each rank (the weights of a batch-sharded
    product, the tokens of an expert-parallel FFN), which the reference's
    ``shard_map`` transpose sums too; otherwise the gradient is placed as
    the input."""
    from torch.distributed.tensor import Partial, Replicate

    if p is None:
        return None
    return tuple(
        Partial() if isinstance(pi, Replicate) and any(
            not isinstance(o[i], Replicate) for o in outs) else pi
        for i, pi in enumerate(p))


def local_call(fn, mesh, args: Sequence, in_pl: Sequence, out_pl):
    """``fn(*local shards)`` under ``local_map`` (the reference's
    ``shard_map``): each tensor of ``args`` is redistributed to its
    placements in ``in_pl`` (``None`` for a non-tensor argument; a plain
    tensor counts as replicated) and ``fn`` gets the local shards; its
    outputs are placed ``out_pl`` (one placement tuple, or a tuple of
    them for several outputs).  Gradients of replicated inputs come back
    partial where an output is sharded (:func:`_grad_placements`)."""
    from torch.distributed.tensor import Placement, Replicate
    from torch.distributed.tensor.experimental import local_map

    multi = len(out_pl) > 0 and not isinstance(out_pl[0], Placement)
    outs = [o for o in (out_pl if multi else (out_pl,)) if o is not None]
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) and p is not None
            else a for a, p in zip(args, in_pl)]
    grads = tuple(_grad_placements(p, outs) for p in in_pl)
    # local_map reads a tuple as one entry per output, a list as one output's
    out_pl = tuple(None if o is None else list(o) for o in out_pl) if multi else list(out_pl)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def conv_on_mesh(fn, x: DTensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """A depthwise causal conv ``fn(x, w, state) -> (out, new_state)`` per
    shard: x (B, L, C) and the state (B, W-1, C) batch-sharded, the
    channels over 'model' where they divide it (each channel is its own
    conv)."""
    mesh, c = x.device_mesh, model_split(x, x.shape[-1])
    px = placements(x, (BATCH_AXES, None, c))
    ps = None if state is None else placements(state, (BATCH_AXES, None, c), mesh)
    out_state = px if w.shape[0] > 1 else None
    return local_call(fn, mesh, (x, w, state), (px, placements(w, (None, c), mesh), ps),
                      (px, out_state))
