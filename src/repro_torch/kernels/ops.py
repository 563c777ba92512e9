"""Dispatch layer for the ported kernels: the model zoo's kernel path.

Each op dispatches on the device of its tensors: a CUDA tensor goes to
the hand-written kernel (or the call raises), a CPU tensor to the plain
torch version.  There is no switch between a plain path and a kernel
path on the card, and no fallback from one to the other.

``moe_gmm``, ``ssd_chunked`` and ``rglru_scan`` go through their autograd
Functions (``MoeGmmFn``, ``SsdIntraChunkFn``, ``RglruScanFn``: the forward
kernel, then the backward kernel) when grad is enabled and an input
requires grad, the train path; otherwise they launch the forward kernel
alone, so serving's launches and bits do not depend on autograd.

On a mesh (DTensor inputs) each op runs on the local shards through
``local_map`` with explicit placements, so no DTensor ever reaches a
kernel wrapper (they raise on one): the batch over ``("pod", "data")``;
attention's query heads over 'model' (:func:`query_heads`), SSD's heads
or RG-LRU's width over 'model' where they divide it, else replicated
over 'model', as GSPMD replicates around a custom call.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from ..distribution.sharding import BATCH_AXES, local_call, model_split, placements, to_placements
from .flash_attention import FlashAttentionFn
from .flash_attention import flash_attention as _flash_attention
from .moe_gmm import MoeGmmFn
from .moe_gmm import moe_gmm as _moe_gmm
from .rglru import RglruScanFn
from .rglru import rglru_scan as _rglru_scan
from .ssd import SsdIntraChunkFn, chunk_cumsum, ssd_intra_chunk

__all__ = ["flash_attention", "flash_attention_grad", "moe_gmm", "ssd_chunked", "rglru_scan"]


def _kv_for(rank: int, per: int, hq: int, hkv: int):
    """What the query heads ``[rank * per, rank * per + per)`` of ``hq``
    read of ``hkv`` key/value heads: a slice of whole GQA groups where
    they form one, else one key/value head per query head (an index
    list).  Query heads past ``hq`` (padding) read the last one."""
    g = hq // hkv
    idx = [min(rank * per + j, hq - 1) // g for j in range(per)]
    n = idx[-1] - idx[0] + 1
    if per % n == 0 and idx == [idx[0] + j // (per // n) for j in range(per)]:
        return slice(idx[0], idx[0] + n)
    return idx


class QueryHeads(NamedTuple):
    """A rank's share of attention's heads (:func:`query_heads`)."""
    rank: int
    per: int            # query heads a rank
    kv: object          # the key/value heads they read: a slice or an index list
    split: bool         # the query heads come split (else replicated, padded here)


def query_heads(mesh, hq: int, hkv: int) -> Optional[QueryHeads]:
    """How attention splits its heads over the 'model' axis of ``mesh``, as
    GSPMD splits the reference's: None where the axis divides the
    key/value heads (whole GQA groups per rank: queries, keys and values
    split alike) or is absent.  Else :class:`QueryHeads`: this
    rank's query heads ``[rank * per, rank * per + per)`` (``split``: the
    axis divides the query heads, which stay split; else they come
    replicated, are padded to a multiple of the axis and the padding's
    output is dropped) and the key/value heads they read (:func:`_kv_for`;
    Megatron's rule when the tensor-parallel degree passes the key/value
    head count), the keys and values replicated over 'model'."""
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    if hkv % m == 0:
        return None
    per = -(-hq // m)
    rank = mesh.get_local_rank("model")
    return QueryHeads(rank, per, _kv_for(rank, per, hq, hkv), hq % m == 0)


def own_queries(q, heads):
    """The local (B, per, L, D) query heads of ``heads`` (:func:`query_heads`)
    from the local ``q``: as they are where split, else cut from the
    replicated heads and zero-padded to ``per``."""
    if heads.split:
        return q
    q = q[:, heads.rank * heads.per:(heads.rank + 1) * heads.per]
    return F.pad(q, (0, 0, 0, 0, 0, heads.per - q.shape[1]))


def query_placements(q, heads, batch, mesh):
    """(the local call's query input placements, its output placements)
    for ``heads`` (:func:`query_heads`), the batch over ``batch``."""
    if heads is None:
        pq = placements(q, (batch, "model", None, None), mesh)
        return pq, pq
    pq = placements(q, (batch, "model" if heads.split else None, None, None), mesh)
    out = placements(q, (batch, None, None, None), mesh)
    return pq, tuple(Shard(1) if n == "model" else p for n, p in zip(mesh.mesh_dim_names, out))


def _attention_on_mesh(fn, q, k, v, return_lse=False):
    """``fn(q, k, v)`` per shard: batch-sharded, the heads over 'model' as
    :func:`query_heads` splits them.  The log-sum-exp (B, H, L) takes the
    output's placements."""
    mesh, hq = q.device_mesh, q.shape[1]
    heads = query_heads(mesh, hq, k.shape[1])
    pq, out_pl = query_placements(q, heads, BATCH_AXES, mesh)
    pk = placements(k, (BATCH_AXES, "model" if heads is None else None, None, None), mesh)
    if heads is None:
        call = fn
    else:
        def call(q_, k_, v_):
            kv = heads.kv
            return fn(own_queries(q_, heads), k_[:, kv].contiguous(), v_[:, kv].contiguous())
    out = local_call(call, mesh, (q, k, v), (pq, pk, pk),
                     (out_pl, out_pl) if return_lse else out_pl)
    if heads is None or heads.split:
        return out
    return tuple(o[:, :hq] for o in out) if return_lse else out[:, :hq]


def flash_attention(q, k, v, **kw):
    """:func:`~repro_torch.kernels.flash_attention.flash_attention`; on a
    mesh, per shard."""
    if isinstance(q, DTensor):
        return _attention_on_mesh(lambda a, b, c: _flash_attention(a, b, c, **kw), q, k, v,
                                  return_lse=kw.get("return_lse", False))
    return _flash_attention(q, k, v, **kw)


def flash_attention_grad(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                         q_offset=0, kv_offset=0, kv_valid_len=None):
    """:func:`flash_attention` that autograd differentiates: the forward
    kernel with the log-sum-exp, then the backward kernel
    (:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`)."""
    def fn(a, b, c):
        return FlashAttentionFn.apply(a, b, c, causal, window, softcap, scale, q_offset,
                                      kv_offset, kv_valid_len)

    if isinstance(q, DTensor):
        return _attention_on_mesh(fn, q, k, v)
    return fn(q, k, v)


def _differentiated(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def moe_gmm(x, wg, wu, wd):
    """The expert FFN (:func:`~repro_torch.kernels.moe_gmm.moe_gmm`), through
    :class:`~repro_torch.kernels.moe_gmm.MoeGmmFn` when autograd records."""
    if _differentiated(x, wg, wu, wd):
        return MoeGmmFn.apply(x, wg, wu, wd)
    return _moe_gmm(x, wg, wu, wd)


def rglru_scan(x, r, i, lam, h0):
    """The RG-LRU scan (:func:`~repro_torch.kernels.rglru.rglru_scan`),
    through :class:`~repro_torch.kernels.rglru.RglruScanFn` when autograd
    records; on a mesh, per shard (the width over 'model' where it
    divides)."""
    if isinstance(x, DTensor):
        mesh, w = x.device_mesh, model_split(x, x.shape[-1])
        px = placements(x, (BATCH_AXES, None, w))
        ph = placements(h0, (BATCH_AXES, w), mesh)
        return local_call(rglru_scan, mesh, (x, r, i, lam, h0),
                          (px, px, px, placements(lam, (w,), mesh), ph), (px, ph))
    if _differentiated(x, r, i, lam, h0):
        return RglruScanFn.apply(x, r, i, lam, h0)
    return _rglru_scan(x, r, i, lam, h0)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
    """Full SSD: the intra-chunk kernel, then the inter-chunk scan in torch.

    x (B, L, H, P), dt (B, L, H) float32, A (H,), Bm/Cm (B, L, G=1, N);
    ``init_state`` (B, H, P, N) seeds the scan (zeros when None; the
    kernel's outputs do not depend on it).  Returns (y (B, L, H, P),
    final_state (B, H, P, N)), both in ``x``'s dtype.  Padded tail rows
    carry ``dt = 0``, so they leave the state untouched.  One chunk from a
    zero state skips the inter-chunk scan: its result is the kernel's.
    On a mesh it runs per shard, the heads over 'model' where they divide.
    """
    if isinstance(x, DTensor):
        mesh, hs = x.device_mesh, model_split(x, x.shape[2])
        px = placements(x, (BATCH_AXES, None, hs, None))
        pbc = placements(Bm, (BATCH_AXES, None, None, None), mesh)
        ps = to_placements((BATCH_AXES, hs, None, None), mesh,
                           (x.shape[0], x.shape[2], x.shape[3], Bm.shape[3]))

        def fn(x_, dt_, A_, B_, C_, s_):
            return ssd_chunked(x_, dt_, A_, B_, C_, chunk=chunk, init_state=s_)

        return local_call(fn, mesh, (x, dt, A, Bm, Cm, init_state),
                          (px, placements(dt, (BATCH_AXES, None, hs), mesh),
                           placements(A, (hs,), mesh),
                           pbc, pbc, None if init_state is None else ps), (px, ps))
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if g != 1:
        raise ValueError(f"ssd_chunked takes one B/C group, got {g}")
    chunk = min(chunk, l)
    nb = -(-l // chunk)
    pad = nb * chunk - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(b, nb, chunk, h, p)
    dtc = dt.reshape(b, nb, chunk, h)
    Bc = Bm.reshape(b, nb, chunk, n)
    Cc = Cm.reshape(b, nb, chunk, n)
    intra = (SsdIntraChunkFn.apply if _differentiated(xc, dtc, A, Bc, Cc)
             else ssd_intra_chunk)
    y_intra, contrib, chunk_decay = intra(xc, dtc, A, Bc, Cc)
    if nb == 1 and init_state is None:
        # one chunk from a zero state (every serve prefill): y_inter is
        # exactly 0 and the state exactly contrib (exp(acum) <= 1 is finite)
        return y_intra.reshape(b, l, h, p).to(x.dtype), contrib[:, 0].to(x.dtype)

    # inter-chunk scan: carry the state, add y_inter per chunk
    ack = chunk_cumsum(dtc, A)                                       # (B,nb,C,H)
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    y_inter = torch.empty_like(y_intra)
    for k in range(nb):
        y_inter[:, k] = torch.einsum("bcn,bhpn,bch->bchp", Cc[:, k].float(), state,
                                     torch.exp(ack[:, k]))
        state = state * chunk_decay[:, k, :, None, None] + contrib[:, k]
    y = (y_intra + y_inter).reshape(b, nb * chunk, h, p)
    if pad:
        y = y[:, :l]
    return y.to(x.dtype), state.to(x.dtype)
