"""Round loop of the structure-of-arrays Monte-Carlo backend, in PyTorch.

This module holds the device side of :mod:`repro_torch.core.sim.soa`: a
loop that advances **R runs of one scenario skeleton simultaneously**
through discrete scheduling rounds.  The host
(:func:`repro_torch.core.sim.soa.build_problem`) precomputes everything
that is lane-independent — the round grid (seam-aligned), per-round job
windows over the release-sorted job axis, EDF permutations, per-segment
schedule bindings, hot-swap capacities/staging volumes — and the loop
only does the lane-dependent part as tensor ops over ``(R, W)``
windows:

* readiness via *finish codes*: every job resolves to one float in a
  ``(R, n_jobs + n_sensors + 1)`` code array (``+inf`` unresolved,
  ``t`` clean finish at ``t``, ``-t - 1`` degraded/dropped at ``t``),
  so dependency propagation is a single gather;
* *backdated exact event times*: rounds only decide **that** something
  happens, the times themselves (ready/start/finish/drop) are computed
  exactly from the inputs;
* policy decisions (cyc / cyc_s / tp_driven / ads_tile) re-expressed as
  masked ladder/EDF tensor ops (see ``_alloc_ladder``), with the
  engine's quota semantics: ``grant = largest candidate <=
  min(want, tiles_left)`` where ``want`` is the smallest candidate
  meeting the deadline (``fit_quota`` equivalence);
* schedule hot-swaps as a seam step taken on the host's say-so
  (capacity switch, vectorized largest-first preemption, staging bytes
  precomputed on the host).

Everything is float32; the absolute times in a <=2 s horizon keep
~1e-7 s resolution.  The contract with the scalar engine is
**distributional** (KS + CI overlap + exact structural invariants).

Differences from the JAX reference's loop, none of which changes what
it computes:

* the round body reads its round from a device counter and per-round
  tables (window start, segment, times), takes its window by
  ``index_select`` and writes it back by ``index_copy_``; the state
  planes, finish codes and accumulators are fixed buffers updated in
  place.  So on the card the body is captured once as CUDA graphs and
  replayed every later round (see :func:`_run_rounds`); the CPU runs
  the same body eagerly.  The seam flags stay host NumPy values: the
  seam step is a Python ``if``, run eagerly on the host's window;
* the allocator's convergence-gated ``while_loop``s run a fixed trip
  count (``1 + alloc_iters`` / ``1 + bump_passes``): the refinement
  maps are idempotent once converged, so the result is the same and no
  round needs a host sync;
* each round's EDF allocations are :func:`edf_alloc_ladder` and ads's
  Phase B start validation :func:`edf_start_keep`: on the card one
  launch each of a hand-written CUDA kernel (``csrc/ladder_grant.cu``)
  that does the permutation, the per-partition prefixes, the ladder fixed
  point and tp's bump per lane in shared memory; on the CPU their plain
  PyTorch versions, the composition of :func:`_alloc_ladder`,
  :func:`_bump_work_conserving` and the EDF gathers.  The standalone
  grant :func:`ladder_grant` (the literal counterpart of the reference's
  Pallas kernel) stays, off the loop's path.

One difference does change what it computes, where the reference has
no counterpart: a problem that takes several rounds a ``dt_s`` step
(``KernelConfig.subrounds``, which the reference's config lacks, so its
problems keep one) projects ads's at-risk finishes from progress synced
on the engine's chunk grid (:func:`_stale_on_chunk_grid`) instead of a
grid anchored at the last sync.  The engine's grid is the right one at
any cadence; a problem of one round a step keeps the anchored grid only
so that it stays bit for bit the reference loop (every cockpit x4 cell
and test).  At 1 ms rounds the two read alike (cockpit x9 on an H100,
96 lanes: lat_ks 0.0795-0.0817 on the engine's grid, 0.0812-0.0834 on
the anchored one); at finer rounds the engine's grid reads closer.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Dict

import numpy as np
import torch

from ... import _cuda
from ..._device import resolve_device
from ...obs import metrics

__all__ = [
    "KernelConfig",
    "NFIELDS",
    "F_STATE",
    "F_READY",
    "F_DEG",
    "F_START",
    "F_FIN",
    "F_DOP",
    "F_PART",
    "F_REM",
    "F_SUB",
    "F_TGT",
    "F_ADV",
    "PEND",
    "READY",
    "RUN",
    "DONE",
    "DROP",
    "POLICY_IDS",
    "simulate",
    "ladder_grant",
    "ladder_grant_reference",
    "edf_alloc_ladder",
    "edf_start_keep",
]

# mutable per-job state: NFIELDS separate (R, N) float32 planes, each
# round reads and writes one (R, W) window of every plane
(
    F_STATE,   # job state code (PEND..DROP)
    F_READY,   # exact ready time (resolve of release + preds)
    F_DEG,     # degraded flag (dropped/degraded predecessor upstream)
    F_START,   # exact (backdated) start time
    F_FIN,     # finish projection while RUNNING; final time once DONE/DROP
    F_DOP,     # currently held tiles
    F_PART,    # partition bound at start
    F_REM,     # remaining work fraction (1 until started; set on preempt)
    F_SUB,     # sub-deadline bound at start (retargets stop at start)
    F_TGT,     # ads slack-shared target bound at start
    F_ADV,     # last progress-sync time (start / freeze / stall end): the
               # scalar engine only advances ``job.progress`` at realloc
               # freezes, so its at-risk and quota projections run on
               # progress *stale since this time* — reproduced here
) = range(11)
NFIELDS = 11

PEND, READY, RUN, DONE, DROP = 0.0, 1.0, 2.0, 3.0, 4.0

POLICY_IDS = {"cyc": 0, "cyc_s": 1, "tp_driven": 2, "ads_tile": 3}
_CYC, _CYC_S, _TP, _ADS = 0, 1, 2, 3

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Static configuration of one scenario cell's round loop."""

    policy: int                # POLICY_IDS value
    R: int                     # lanes (runs)
    W: int                     # window width over the job axis
    C: int                     # DoP-candidate ladder width
    PM: int                    # max predecessor in-degree
    P: int                     # partitions
    tile_flops: float
    fixed_s: float
    decision_s: float
    per_hop_s: float
    inv_bw: float              # 1 / migration bandwidth
    realloc_gate: float = 1.0
    admission: bool = True     # ads ablation / cyc ERT gate
    quota_control: bool = True
    #: deadline-drop regime: 0 = none (the runner's default
    #: ``drop_policy="soft"`` arms no e2e timers for tp/ads), 1 =
    #: sub-deadline termination (cyc's unconditional budget
    #: enforcement), 2 = e2e-deadline dequeue (``drop_policy="hard"``)
    drop_mode: int = 0
    #: chunk boundaries per job (SimConfig.n_chunks): the scalar engine
    #: syncs a running job's progress only at its chunk events, so the
    #: ads at-risk projection runs on progress stale by up to one chunk
    #: interval — the loop reproduces that bounded staleness
    n_chunks: int = 6
    alloc_iters: int = 8       # monotone EDF-allocation refinement steps
    bump_passes: int = 8       # tp work-conserving bump refinement steps
    #: rounds per ``dt_s`` step of the grid (``soa._subrounds_for``); above
    #: one, ads's at-risk projection takes the engine's chunk grid and
    #: the loop counts the reallocations of the rounds after a step's
    #: first (module docstring)
    subrounds: int = 1


# ---------------------------------------------------------------------------
# allocation primitives
# ---------------------------------------------------------------------------
def _ladder_grant(limit: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Largest candidate DoP <= ``limit`` (0 when none fits).

    ``limit``: (R, W) float tile budget per job; ``cand``: (W, C) or
    (R, W, C) candidate values (padded by repeating the last rung).
    This is the vectorized form of the engine's quota walk: with
    ``limit = min(want, tiles_left)`` it reproduces ``fit_quota``'s
    "smallest candidate meeting the deadline, else the largest that
    fits" exactly.  The plain version of :func:`ladder_grant`.
    """
    ok = cand <= limit[..., None] + 0.5
    return torch.where(ok, cand, torch.zeros_like(cand)).amax(dim=-1)


def ladder_grant_reference(limit: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """NumPy oracle for the grant select."""
    ok = cand <= limit[..., None] + 0.5
    return np.max(np.where(ok, cand, 0.0), axis=-1)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LADDER_SIG = {
    "ladder_grant": (_I, [_P, _P, _P, _I, _I, _I, _LL, _P]),
    "alloc_ladder": (_I, [_P, _P, _P, _LL, _P, _LL, _P, _LL, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P]),
    "start_keep": (_I, [_P, _P, _LL, _P, _LL, _P, _P, _I, _I, _I, _P]),
}


def _ladder_grant_cuda(limit: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ladder_grant.cu`` on the current stream."""
    if limit.dtype != _F32 or cand.dtype != _F32:
        raise TypeError(
            f"ladder_grant takes float32, got {limit.dtype} / {cand.dtype}"
        )
    if cand.device != limit.device:
        raise ValueError(f"limit on {limit.device}, cand on {cand.device}")
    if limit.dim() != 2:
        raise ValueError(f"limit must be (R, W), got {tuple(limit.shape)}")
    R, W = limit.shape
    if cand.dim() == 2 and cand.shape[0] == W:
        stride = 0
    elif cand.dim() == 3 and tuple(cand.shape[:2]) == (R, W):
        stride = W * cand.shape[2]
    else:
        raise ValueError(
            f"cand must be (W, C) or (R, W, C) for limit {tuple(limit.shape)}, "
            f"got {tuple(cand.shape)}"
        )
    C = cand.shape[-1]
    if R * W == 0 or C == 0:
        raise ValueError(f"empty ladder grant: R={R} W={W} C={C}")
    if not (limit.is_contiguous() and cand.is_contiguous()):
        raise ValueError("ladder_grant takes contiguous tensors")
    lib = _cuda.load("ladder_grant", _LADDER_SIG)
    out = torch.empty((R, W), dtype=_F32, device=limit.device)
    err = lib.ladder_grant(
        limit.data_ptr(), cand.data_ptr(), out.data_ptr(), R, W, C, stride,
        torch.cuda.current_stream(limit.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ladder_grant launch failed: CUDA error {err}")
    ladder_grant.launches += 1
    return out


def ladder_grant(limit: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """The grant select on whatever device ``limit`` lies on: the CUDA
    kernel for a CUDA tensor (raising if it cannot build or launch),
    the plain version for a CPU tensor.  ``ladder_grant.launches``
    counts kernel launches."""
    if limit.device.type == "cuda":
        return _ladder_grant_cuda(limit, cand)
    if limit.device.type != "cpu":
        raise ValueError(f"ladder_grant: unsupported device {limit.device}")
    return _ladder_grant(limit, cand)


ladder_grant.launches = 0


def _class_prefix(P, part_s, cap_p):
    """Per-partition queue-prefix operators for one sorted queue of ``P``
    partitions.

    Returns ``(excl, total, capg)``: ``excl(d)`` is each entry's
    exclusive prefix sum of ``d`` over earlier same-partition entries,
    ``total(d)`` the inclusive whole-partition sum seen by each entry,
    and ``capg`` the entry's own partition budget.  With one partition
    these are a plain cumsum / broadcast sum; multi-partition uses a
    same-partition strict-lower mask as a batched matvec (full float32:
    the operands are small integer tile counts and must sum exactly).
    The plain versions' form; the card's kernel takes the same prefixes
    by a scan in shared memory."""
    if P == 1:
        capg = cap_p[:, :1].expand(part_s.shape)

        def excl(d):
            return torch.cumsum(d, dim=1) - d

        def total(d):
            return d.sum(dim=1, keepdim=True).expand(d.shape)

        return excl, total, capg

    part_i = part_s.to(torch.int64).clamp(0, P - 1)
    same = (part_i[:, :, None] == part_i[:, None, :]).to(_F32)
    W = part_i.shape[1]
    tril = torch.tril(torch.ones((W, W), dtype=_F32, device=part_s.device), -1)
    Mpre = same * tril[None]
    capg = torch.gather(cap_p.expand(part_i.shape[0], -1), 1, part_i)

    def excl(d):
        return torch.bmm(Mpre, d[:, :, None])[:, :, 0]

    def total(d):
        return torch.bmm(same, d[:, :, None])[:, :, 0]

    return excl, total, capg


def _alloc_ladder(want, entry, part_s, cand_s, cap_p, alloc_iters):
    """Feasible EDF ladder allocation over one round's sorted queue.

    ``want``: (R, W) desired DoP per queue entry (EDF order);
    ``entry``: (R, W) bool participation mask; ``part_s``: (R, W)
    partition id per entry; ``cand_s``: (W, C) or (R, W, C) candidate
    rows; ``cap_p``: (R, P) tile budget per partition.

    The scalar engine walks the queue sequentially, each entry seeing
    the tiles left by its predecessors.  Here a monotone fixed-point
    iteration replaces the walk: start from ``want``, compute each
    entry's exclusive prefix load per partition, re-grant against
    ``min(want, left)``, repeat.  Grants only ever shrink, so the
    result is always feasible.

    The refinement map is a pure function of ``cur``: once an
    application leaves it unchanged every further one does too.  So
    ``1 + alloc_iters`` applications give the reference's
    convergence-gated loop's result without testing convergence, which
    would cost a host sync per step.
    """
    zero = torch.zeros_like(want)
    want = torch.where(entry, want, zero)
    excl, _, capg = _class_prefix(cap_p.shape[1], part_s, cap_p)
    cur = want
    for _ in range(1 + alloc_iters):
        limit = torch.minimum(want, capg - excl(cur))
        cur = torch.where(entry, _ladder_grant(limit, cand_s), zero)
    return cur


def _bump_work_conserving(grant, entry, part_s, cand_s, cap_p, bump_passes):
    """tp_driven's saturation pass: spend leftover tiles by bumping
    queue entries (EDF order) to their next candidate rung.  Each pass
    assumes every earlier eligible entry takes its bump, so it never
    over-commits.  ``1 + bump_passes`` passes, by the same idempotence
    argument as :func:`_alloc_ladder`."""
    excl, total, capg = _class_prefix(cap_p.shape[1], part_s, cap_p)

    def one_pass(grant):
        above = cand_s > grant[..., None] + 0.5
        nxt = torch.where(above, cand_s, float("inf")).amin(dim=-1)
        delta = torch.where(
            entry & torch.isfinite(nxt), nxt - grant, torch.zeros_like(grant)
        )
        leftg = capg - total(grant)
        # the scalar walk skips an entry whose bump no longer fits and
        # still offers the tiles to later entries; a plain prefix gate
        # would block them, so relax the take-set to that fixed point
        pos = delta > 0
        take = pos
        for _ in range(3):
            cume = excl(torch.where(take, delta, torch.zeros_like(delta)))
            take = pos & (cume + delta <= leftg + 0.5)
        # enforce feasibility of the final set (prefix over taken only)
        cume = excl(torch.where(take, delta, torch.zeros_like(delta)))
        ok = take & (cume + delta <= leftg + 0.5)
        return torch.where(ok, grant + delta, grant)

    for _ in range(1 + bump_passes):
        grant = one_pass(grant)
    return grant


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation (build_problem's ``iperm``)."""
    return torch.argsort(perm)


def _edf_alloc_ladder(want, entry, part, cand_rows, cap_p, perm, alloc_iters,
                      bump_passes=None):
    """Plain version of :func:`edf_alloc_ladder`: EDF-permute,
    ladder-allocate, optionally bump, inverse-permute."""
    R, W = want.shape
    want_s = want.index_select(1, perm)
    entry_s = entry.index_select(1, perm)
    part_s = part.expand(R, W).index_select(1, perm)
    cand_s = cand_rows.index_select(-2, perm)
    cap_p = cap_p.expand(R, -1)
    grant_s = _alloc_ladder(want_s, entry_s, part_s, cand_s, cap_p, alloc_iters)
    if bump_passes is not None:
        grant_s = _bump_work_conserving(
            grant_s, entry_s, part_s, cand_s, cap_p, bump_passes
        )
    return grant_s.index_select(1, _inverse(perm))


def _edf_start_keep(d, part, avail, perm):
    """Plain version of :func:`edf_start_keep`."""
    R, W = d.shape
    d_s = d.index_select(1, perm)
    excl, _, availg = _class_prefix(
        avail.shape[1], part.expand(R, W).index_select(1, perm), avail.expand(R, -1)
    )
    keep_s = (d_s > 0) & (excl(d_s) + d_s <= availg + 0.5)
    return keep_s.index_select(1, _inverse(perm))


#: the most dynamic shared memory one block may use on Hopper
_SMEM_MAX = 232448


def _alloc_smem_bytes(W, C, P):
    """Shared memory of one block of the fused kernel (in step with
    ``alloc_smem_bytes`` in ``csrc/ladder_grant.cu``): scan buffer, five
    float and three int planes of the queue, the ladder rows, warp totals,
    segment starts, two flag planes."""
    return 4 * (W + 1) + 32 * W + 4 * W * C + 128 + 4 * (P + 1) + 2 * W


def _bad_rows(t, R, n, name):
    return ValueError(
        f"{name} must be ({R}, {n}) or (1, {n}) with contiguous rows, got "
        f"shape {tuple(t.shape)} strides {t.stride()}"
    )


_FUSED = []  # the fused kernel's C entry points, bound at first launch
_BOOL, _I64 = torch.bool, torch.int64


def _fused():
    if not _FUSED:
        lib = _cuda.load("ladder_grant", _LADDER_SIG)
        _FUSED.extend((lib.alloc_ladder, lib.start_keep))
    return _FUSED


# The two launchers check on attributes only, and read each attribute
# once: the round loop runs under sync-debug "error" (nothing here may
# read a value) and calls them once per allocation, so their host time is
# the loop's pace.  part and cap_p / avail are (R, n) or (1, n) with
# contiguous rows; a lane stride of 0 makes every lane read row 0.
def _edf_alloc_ladder_cuda(want, entry, part, cand_rows, cap_p, perm,
                           alloc_iters, bump_passes):
    """Launch the fused EDF allocator of ``csrc/ladder_grant.cu``."""
    shape = want.shape
    if len(shape) != 2 or not want.is_contiguous():
        raise ValueError(f"edf_alloc_ladder: want must be a contiguous (R, W), got {shape}")
    R, W = shape
    dev = want.get_device()
    if not (entry.get_device() == part.get_device() == cand_rows.get_device()
            == cap_p.get_device() == perm.get_device() == dev):
        raise ValueError(f"edf_alloc_ladder: every operand must be on cuda:{dev}")
    if not (want.dtype is part.dtype is cand_rows.dtype is cap_p.dtype is _F32):
        raise TypeError("edf_alloc_ladder: want, part, cand_rows and cap_p must be float32")
    if entry.dtype is not _BOOL or entry.shape != shape or not entry.is_contiguous():
        raise ValueError("edf_alloc_ladder: entry must be a contiguous bool (R, W)")
    if perm.dtype is not _I64 or perm.shape != (W,) or not perm.is_contiguous():
        raise ValueError(f"edf_alloc_ladder: perm must be a contiguous int64 ({W},)")
    cshape, cstride = cand_rows.shape, cand_rows.stride()
    C = cshape[-1]
    if len(cshape) == 2 and cshape[0] == W:
        cand_ls = 0
    elif len(cshape) == 3 and cshape[0] == R and cshape[1] == W:
        cand_ls = cstride[0]
    else:
        raise ValueError(
            f"edf_alloc_ladder: cand_rows must be ({W}, C) or ({R}, {W}, C), got "
            f"{tuple(cshape)}"
        )
    if cstride[-2] != C or (C > 1 and cstride[-1] != 1):
        raise ValueError("edf_alloc_ladder: cand_rows' rows must be contiguous")
    (pr, pw), (part_ls, ps1) = part.shape, part.stride()
    if pw != W or (pr != R and pr != 1) or ps1 != 1:
        raise _bad_rows(part, R, W, "part")
    (cr, P), (cap_ls, cs1) = cap_p.shape, cap_p.stride()
    if (cr != R and cr != 1) or (cs1 != 1 and P > 1):
        raise _bad_rows(cap_p, R, P, "cap_p")
    if R * W * C * P == 0:
        raise ValueError(f"edf_alloc_ladder: empty problem R={R} W={W} C={C} P={P}")
    if _alloc_smem_bytes(W, C, P) > _SMEM_MAX:
        raise ValueError(
            f"edf_alloc_ladder: a queue of W={W} entries (C={C}, P={P}) does "
            "not fit one block's shared memory"
        )
    out = torch.empty_like(want)
    err = _fused()[0](
        want.data_ptr(), entry.data_ptr(), part.data_ptr(), part_ls if pr != 1 else 0,
        cand_rows.data_ptr(), cand_ls, cap_p.data_ptr(), cap_ls if cr != 1 else 0,
        perm.data_ptr(), out.data_ptr(), R, W, C, P, alloc_iters,
        -1 if bump_passes is None else bump_passes,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err != 0:
        raise RuntimeError(f"alloc_ladder launch failed: CUDA error {err}")
    edf_alloc_ladder.launches += 1
    return out


def _edf_start_keep_cuda(d, part, avail, perm):
    """Launch the fused kernel's start-validation mode."""
    shape = d.shape
    if len(shape) != 2 or not d.is_contiguous():
        raise ValueError(f"edf_start_keep: d must be a contiguous (R, W), got {shape}")
    R, W = shape
    dev = d.get_device()
    if not (part.get_device() == avail.get_device() == perm.get_device() == dev):
        raise ValueError(f"edf_start_keep: every operand must be on cuda:{dev}")
    if not (d.dtype is part.dtype is avail.dtype is _F32):
        raise TypeError("edf_start_keep: d, part and avail must be float32")
    if perm.dtype is not _I64 or perm.shape != (W,) or not perm.is_contiguous():
        raise ValueError(f"edf_start_keep: perm must be a contiguous int64 ({W},)")
    (pr, pw), (part_ls, ps1) = part.shape, part.stride()
    if pw != W or (pr != R and pr != 1) or ps1 != 1:
        raise _bad_rows(part, R, W, "part")
    (ar, P), (avail_ls, as1) = avail.shape, avail.stride()
    if (ar != R and ar != 1) or (as1 != 1 and P > 1):
        raise _bad_rows(avail, R, P, "avail")
    if R * W * P == 0 or _alloc_smem_bytes(W, 0, P) > _SMEM_MAX:
        raise ValueError(f"edf_start_keep: R={R}, W={W}, P={P} does not fit one block")
    keep = torch.empty_like(d, dtype=_BOOL)
    err = _fused()[1](
        d.data_ptr(), part.data_ptr(), part_ls if pr != 1 else 0, avail.data_ptr(),
        avail_ls if ar != 1 else 0, perm.data_ptr(), keep.data_ptr(), R, W, P,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err != 0:
        raise RuntimeError(f"start_keep launch failed: CUDA error {err}")
    edf_alloc_ladder.launches += 1
    return keep


def edf_alloc_ladder(want, entry, part, cand_rows, cap_p, perm, *, alloc_iters,
                     bump_passes=None):
    """One round's EDF allocation for R lanes: permute the queue into
    EDF order by ``perm``, run the ladder fixed point (``1 +
    alloc_iters`` steps), tp_driven's work-conserving bump when
    ``bump_passes`` is not None (``1 + bump_passes`` passes), and return
    the grants in window order.

    ``want``: (R, W) float32; ``entry``: (R, W) bool; ``part``: (R, W)
    or (1, W) partition ids; ``cand_rows``: (W, C) or (R, W, C) ladder
    rows in window order; ``cap_p``: (R, P) or (1, P) budgets; ``perm``:
    (W,) int64.  On a CUDA tensor one launch of the fused kernel
    (raising if it cannot build or launch), on a CPU tensor the plain
    version :func:`_edf_alloc_ladder`.  ``edf_alloc_ladder.launches``
    counts the fused kernel's launches, those of :func:`edf_start_keep`
    included; the ``obs`` counter ``soa_alloc_calls`` counts the calls
    of both on every device."""
    metrics.count("soa_alloc_calls")
    if want.is_cuda:
        return _edf_alloc_ladder_cuda(want, entry, part, cand_rows, cap_p, perm,
                                      alloc_iters, bump_passes)
    if want.device.type != "cpu":
        raise ValueError(f"edf_alloc_ladder: unsupported device {want.device}")
    return _edf_alloc_ladder(want, entry, part, cand_rows, cap_p, perm,
                             alloc_iters, bump_passes)


edf_alloc_ladder.launches = 0


def edf_start_keep(d, part, avail, perm):
    """ads_tile's Phase B start validation: in EDF order, keep an entry
    with ``d > 0`` whose same-partition prefix of ``d`` plus its own fits
    ``avail`` (+ 0.5); returns the (R, W) bool mask in window order.
    Shapes as :func:`edf_alloc_ladder`'s ``want``, ``part``, ``cap_p``
    and ``perm``.  On a CUDA tensor one launch of the fused kernel
    (counted by ``edf_alloc_ladder.launches``), on a CPU tensor the
    plain version :func:`_edf_start_keep`.  Counted by the ``obs``
    counter ``soa_alloc_calls``."""
    metrics.count("soa_alloc_calls")
    if d.is_cuda:
        return _edf_start_keep_cuda(d, part, avail, perm)
    if d.device.type != "cpu":
        raise ValueError(f"edf_start_keep: unsupported device {d.device}")
    return _edf_start_keep(d, part, avail, perm)


# ---------------------------------------------------------------------------
# the round loop
# ---------------------------------------------------------------------------
_HOST_KEYS = ("t0", "t1", "seg", "lo", "entry", "swap")

#: columns of the per-round time table ``round_t``: the round's bounds,
#: then the two thresholds the body compares against, each taken in
#: float64 on the host and rounded to float32 once, as a float32 op
#: rounds a Python float operand
_T0, _T1, _T0_LO, _T1_HI = range(4)
#: rows of the round's window of the per-job constants (``job_w``), of
#: the segment's per-job bindings (``seg_w``) and of its per-partition
#: numbers (``seg_pw``)
_REL, _E2E, _SYNC, _CKPT = range(4)
_ERT, _SUB, _TGT, _PDOP, _PART = range(5)
_CAPS, _HOPS = range(2)


def _upload(const_np: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Every per-cell constant on ``device``, before round 0 (a copy to
    the card inside the loop would be a host sync)."""
    out = {}
    for k, v in const_np.items():
        if k in _HOST_KEYS:
            continue
        v = np.ascontiguousarray(v)
        if v.dtype.kind in "iu":
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(v).to(device)
    return out


def _round_tables(host: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The per-round tables the body reads at the device's round counter:
    ``round_lo`` and ``round_seg`` (int64) and ``round_t`` (float32, one
    row a round: t0, t1, ``t0 - 1e-9``, ``t1 + 1e-12``)."""
    t0 = np.asarray(host["t0"], dtype=np.float64)
    t1 = np.asarray(host["t1"], dtype=np.float64)
    t = np.stack([t0, t1, t0 - 1e-9, t1 + 1e-12], axis=1).astype(np.float32)
    return {
        "round_lo": torch.from_numpy(np.asarray(host["lo"], dtype=np.int64)).to(device),
        "round_seg": torch.from_numpy(np.asarray(host["seg"], dtype=np.int64)).to(device),
        "round_t": torch.from_numpy(t).to(device),
    }


class _Handoff:
    """The tensors one step of the round hands to a later step, by name.

    Each keeps one address from round to round, so that a step captured
    as a CUDA graph finds its inputs where the earlier steps left them:
    the first round keeps a copy, later rounds copy into it, and while
    the steps are captured a name takes the graph's own output, which
    every replay writes in the same place.  On the card only round 0 and
    the eager launches' outputs reach the copy; the CPU, which replays
    nothing, copies every round too, so that it runs the very steps the
    card captures and its tests can hold their addresses fixed."""

    def __init__(self):
        self.__dict__["capturing"] = False

    def put(self, **tensors):
        d = self.__dict__
        for k, t in tensors.items():
            if d["capturing"]:
                d[k] = t
            elif k in d:
                d[k].copy_(t)
            else:
                d[k] = t.clone()


@dataclasses.dataclass
class _Body:
    """One round of the loop: ``steps`` in order, each ``(span, step,
    launch)``: the registry phase it opens (or None), a step that reads
    the round from the device's counter, and the fused allocator's call
    after it (or None), which takes the round's EDF permutation.  ``seam``
    is the hot-swap, on the host's window; ``out`` what the loop returns."""

    steps: list
    seam: object
    handoff: _Handoff
    out: tuple


def _stale_on_chunk_grid(fin, t1, adv, d_cur, n_chunks: int):
    """Share of a running job's work left as of its last progress sync
    before ``t1``, as the event-driven engine holds it: the engine syncs
    at the job's chunk events, which fall on its progress grid (``k /
    n_chunks`` of the job), and at a freeze, resume or start (``adv``).
    The sync is the later of the two (+1e-5: a point just passed reads
    passed through float32 rounding).  ``fin`` is the job's projected
    finish at its current duration ``d_cur``."""
    dd = torch.clamp(d_cur, min=1e-12)
    u_sync = ((fin - adv) / dd).clamp(0.0, 1.0)
    p_now = (1.0 - (fin - torch.maximum(adv, t1)) / dd).clamp(0.0, 1.0)
    u_grid = 1.0 - torch.floor(p_now * n_chunks + 1e-5) / n_chunks
    return torch.minimum(u_sync, u_grid)


def _round_body(cfg: KernelConfig, dc, work, io, codes) -> _Body:
    """The round loop's state and its round as steps.

    Every step reads the round at the device's round counter (the last
    step advances it) and its window by ``index_select``, and writes only
    fixed buffers in place or the handoff: so one capture of the steps
    replays every later round.  Between steps, the allocator's launches
    run eagerly on operands of the shapes and strides the kernel has
    always been given."""
    R, W, P, C, PM = cfg.R, cfg.W, cfg.P, cfg.C, cfg.PM
    tf = cfg.tile_flops
    pol = cfg.policy
    dev = work.device
    N = work.shape[1]
    S_ = int(dc["caps"].shape[0])

    def zeros(shape):
        return torch.zeros(shape, dtype=_F32, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=_F32, device=dev)

    fills = {F_FIN: float("inf"), F_SUB: float("inf"), F_TGT: float("inf"),
             F_PART: -1.0, F_REM: 1.0}
    planes = torch.empty((NFIELDS, R, N), dtype=_F32, device=dev)
    for f in range(NFIELDS):
        planes[f].fill_(fills.get(f, 0.0))
    stall_end = zeros((R, P))
    busy = zeros((R, S_))
    rel = zeros((R, S_))
    nre = zeros((R,))
    # reallocations of the rounds after a step's first (sub-rounds only)
    nre_sub = zeros((R,)) if cfg.subrounds > 1 else None
    rbytes = zeros((R,))
    dwork = zeros((R,))

    ZW = zeros((R, W))
    INFW = full((R, W), float("inf"))
    ar_p = torch.arange(P, dtype=_I64, device=dev)
    pos = torch.arange(W, dtype=_F32, device=dev)
    ZP1 = zeros((R, 1))
    # the round counter, and the constants stacked so that one gather
    # takes each group's window
    rnd = torch.zeros((1,), dtype=_I64, device=dev)
    ar_w = torch.arange(W, dtype=_I64, device=dev)
    round_lo, round_seg, round_t = dc["round_lo"], dc["round_seg"], dc["round_t"]
    job_c = torch.stack([dc[k] for k in ("release", "e2e", "sync", "ckpt")])
    seg_c = torch.stack([dc[k] for k in ("ert", "sub", "tgt", "pdop", "part")]).reshape(5, -1)
    part_ix = dc["part"].to(_I64).clamp(0, P - 1).reshape(-1)
    cands = dc["cands"].reshape(-1, C)
    seg_p = torch.stack([dc["caps"], dc["hops"]])
    h = _Handoff()

    def dur(work, io, sync, c):
        cc = torch.clamp(c, min=1.0)
        return work / (cc * tf) + io + sync * (cc - 1.0)

    def where0(m, x):
        return torch.where(m, x, ZW)

    def seam_step(state, fin, dop, rem, adv, pborn, stall_end, nre, rbytes,
                  t0, workw, iow, syncw, ckptw, capsg, hopsg, stagedg):
        """Schedule hot-swap at a segment-entry round (time = t0):
        capacity switch, largest-first preemption down to the new caps,
        one stop-migrate-restart stall per partition charged with the
        host-precomputed staging volume plus preempted checkpoints."""
        run = state == RUN
        d_cur = dur(workw, iow, syncw, dop)
        moved = zeros((R, P))
        vict = torch.zeros((R, W), dtype=torch.bool, device=dev)
        for p in range(P):
            mp = run & (pborn == p)
            dv = where0(mp, dop)
            over = dv.sum(dim=1) - capsg[p]
            # removal order: largest dop first, later jid first on ties
            key = -(dv * (W + 1.0) + pos[None, :])
            order = torch.argsort(key, dim=1, stable=True)
            inv = torch.argsort(order, dim=1, stable=True)
            dsort = torch.gather(dv, 1, order)
            cume = torch.cumsum(dsort, dim=1) - dsort
            v_sorted = (dsort > 0) & (cume < over[:, None] - 1e-6)
            vp = torch.gather(v_sorted, 1, inv)
            vict = vict | vp
            moved[:, p] = stagedg[p] + where0(vp, ckptw * dop).sum(dim=1)
        stall = (
            cfg.fixed_s + cfg.decision_s + hopsg[None, :] * cfg.per_hop_s
            + moved * cfg.inv_bw
        )
        stall_end = torch.maximum(stall_end, t0 + stall)
        # preempted: back to READY with exact residual fraction
        rem = torch.where(
            vict,
            ((fin - t0) / torch.clamp(d_cur, min=1e-12)).clamp(0.0, 1.0),
            rem,
        )
        state = torch.where(vict, READY, state)
        dop = where0(~vict, dop)
        fin = torch.where(vict, INFW, fin)
        # freeze survivors for their partition's stall
        stall_own = torch.stack([
            where0(pborn == p, stall[:, p][:, None].expand(R, W))
            for p in range(P)
        ]).sum(dim=0)
        still = state == RUN
        fin = torch.where(still, fin + stall_own, fin)
        adv = torch.where(still, t0 + stall_own, adv)
        nre = nre + float(P)
        rbytes = rbytes + moved.sum(dim=1)
        return state, fin, dop, rem, adv, stall_end, nre, rbytes

    def seam(lo, sg, t0):
        """The hot-swap on the window by the host's ``lo``, before the
        round's steps, written back into the planes and accumulators."""
        hi = lo + W
        win = [planes[f, :, lo:hi] for f in (F_STATE, F_FIN, F_DOP, F_REM, F_ADV)]
        out = seam_step(
            *win, planes[F_PART, :, lo:hi], stall_end, nre, rbytes, t0,
            work[:, lo:hi], io[:, lo:hi], dc["sync"][lo:hi], dc["ckpt"][lo:hi],
            dc["caps"][sg], dc["hops"][sg], dc["staged"][sg],
        )
        for w, new in zip(win, out[:5]):
            w.copy_(new)
        for a, new in zip((stall_end, nre, rbytes), out[5:]):
            a.copy_(new)

    def resolve():
        """The round's window, finishes, readiness, deadline drops, finish
        codes and the accounting of the pre-policy state."""
        tt = round_t.index_select(0, rnd)[0]
        t0, t1 = tt[_T0], tt[_T1]
        sg = round_seg.index_select(0, rnd)
        idx = round_lo.index_select(0, rnd) + ar_w
        fidx = sg * N + idx
        win = planes.index_select(2, idx)
        (state, ready_t, deg, start, fin, dop, pborn, rem, subb, tgtb,
         adv) = win.unbind(0)
        job_w = job_c.index_select(1, idx)
        relw, e2ew, syncw, _ckptw = job_w.unbind(0)
        predw = dc["preds"].index_select(0, idx)
        workw = work.index_select(1, idx)
        iow = io.index_select(1, idx)
        seg_w = seg_c.index_select(1, fidx)
        _ertw, subw, _tgtw, pdw, parw = seg_w.unbind(0)
        d_cur = dur(workw, iow, syncw, dop)

        # ---- finishes ------------------------------------------------
        run = state == RUN
        if cfg.drop_mode == 1:
            lim_run = subb
        elif cfg.drop_mode == 2:
            lim_run = e2ew[None, :].expand(R, W)
        else:
            lim_run = INFW
        drop_run = run & (lim_run <= t1) & (fin > lim_run + 1e-9)
        done_now = run & (fin <= t1) & ~drop_run
        state = torch.where(done_now, DONE, state)

        # ---- readiness (release passed + all predecessors resolved) --
        pend = state == PEND
        pcodes = codes.index_select(1, predw.reshape(-1)).reshape(R, W, PM)
        unresolved = torch.isinf(pcodes).any(dim=-1)
        rtimes = torch.where(pcodes < 0, -pcodes - 1.0, pcodes)
        res_t = torch.maximum(relw[None, :], rtimes.amax(dim=-1))
        newready = pend & (relw[None, :] <= t1) & ~unresolved
        state = torch.where(newready, READY, state)
        ready_t = torch.where(newready, res_t, ready_t)
        deg = torch.where(newready, (pcodes < -0.5).any(dim=-1).to(_F32), deg)

        # ---- deadline drops (exact drop times, backdated) ------------
        if cfg.drop_mode == 1:
            lim_rdy = subw[None, :].expand(R, W)
        elif cfg.drop_mode == 2:
            lim_rdy = e2ew[None, :].expand(R, W)
        else:
            lim_rdy = INFW
        rdy = state == READY
        drop_rdy = rdy & (lim_rdy <= t1)
        droptime = torch.where(drop_run, lim_run, torch.maximum(lim_rdy, ready_t))
        dropping = drop_run | drop_rdy
        rem_d = torch.where(
            drop_run,
            ((fin - droptime) / torch.clamp(d_cur, min=1e-12)).clamp(0.0, 1.0),
            rem,
        )
        d_plan = dur(workw, iow, syncw, pdw[None, :])
        dwork.add_(where0(dropping, rem_d * d_plan * pdw[None, :]).sum(dim=1))
        state = torch.where(dropping, DROP, state)
        fin = torch.where(dropping, droptime, fin)
        deg = torch.where(dropping, 1.0, deg)

        # in-round capacity-release times per partition: a job that sat
        # queued through earlier rounds can only start at the event that
        # made room (a completion or drop), never back at its admission
        # time
        fpart = torch.where(drop_rdy, parw[None, :], pborn).to(_I64)
        freeing = done_now | dropping
        freed_t_p = torch.where(
            freeing[..., None] & (fpart[..., None] == ar_p),
            fin[..., None], t0,
        ).amax(dim=1)

        # ---- finish codes (idempotent re-derivation for the window) --
        terminal = state >= DONE
        code_w = torch.where(
            terminal, torch.where(deg > 0.5, -fin - 1.0, fin), INFW
        )
        codes.index_copy_(1, idx, code_w)  # in place: one window per round

        # ---- accounting: tile presence of the pre-policy state -------
        run = state == RUN
        pborn_i = pborn.to(_I64)
        oh_born = pborn_i[..., None] == ar_p
        alloc_p = torch.where(
            run[..., None] & oh_born, dop[..., None], 0.0
        ).sum(dim=1)
        presence = where0(
            state >= RUN,
            dop * (torch.clamp(fin, max=t1) - torch.clamp(start, min=t0)).clamp(min=0.0),
        ).sum(dim=1)
        ov_p = (torch.clamp(stall_end, max=t1) - t0).clamp(min=0.0)
        realloc_r = (alloc_p * ov_p).sum(dim=1)
        h.put(
            tt=tt, sg=sg, idx=idx, win=win, job_w=job_w, seg_w=seg_w,
            parw_ix=part_ix.index_select(0, fidx), candw=cands.index_select(0, fidx),
            seg_pw=seg_p.index_select(1, sg)[:, 0], workw=workw, iow=iow,
            state=state, ready_t=ready_t, deg=deg, fin=fin, d_cur=d_cur, run=run,
            pborn_i=pborn_i, freed_t_p=freed_t_p, alloc_p=alloc_p,
            presence=presence, realloc_r=realloc_r,
        )

    # ---- the window as the later steps read it --------------------------
    def window(*fields):
        return [h.win[f] for f in fields]

    def part_row():
        return h.seg_w[_PART][None, :]

    def cap_pool():
        return h.seg_pw[_CAPS][None, :].expand(R, P)

    def want_of(rem_f, slack, d_lad):
        """fit_quota's ladder target with no tile cap (cap folds in at
        grant time): smallest candidate meeting the deadline, else the
        largest rung."""
        candw = h.candw
        if not cfg.quota_control:
            return candw[None, :, -1].expand(R, W)
        meet = rem_f[..., None] * d_lad <= slack[..., None] + 1e-12
        # argmax over an integer cast returns the first True
        first = torch.argmax(meet.to(torch.int32), dim=-1)
        anym = meet.any(dim=-1)
        picked = torch.gather(
            candw[None].expand(R, W, C), 2, first[..., None]
        )[..., 0]
        return torch.where(anym, picked, candw[None, :, -1])

    def edf_alloc(want_m, entry_m, part_m, cand_rows, pool, perm, bump=False):
        """EDF-permute, ladder-allocate, inverse-permute: one launch on
        the card."""
        return edf_alloc_ladder(
            want_m, entry_m, part_m, cand_rows, pool, perm,
            alloc_iters=cfg.alloc_iters,
            bump_passes=cfg.bump_passes if bump else None,
        )

    def per_part(m, ids, val=None):
        """(R, P) per-partition sum (or any) keyed by an id array."""
        oh = ids.expand(R, W)[..., None] == ar_p
        if val is None:
            return (m[..., None] & oh).any(dim=1)
        v = val.expand(R, W) if torch.is_tensor(val) else torch.full_like(ZW, val)
        return torch.where(m[..., None] & oh, v[..., None], 0.0).sum(dim=1)

    def own_of(arr_p, idx_i, padval):
        pad = torch.full((R, 1), padval, dtype=arr_p.dtype, device=dev)
        return torch.gather(
            torch.cat([arr_p, pad], dim=1), 1, idx_i.clamp(0, P),
        )

    # ---- policy pass ------------------------------------------------------
    def policy_head():
        """Admission, the ready set and the free tiles, every policy's."""
        t1 = h.tt[_T1]
        ertw, parw_ix = h.seg_w[_ERT], h.parw_ix
        stall_rdy = stall_end.index_select(1, parw_ix)
        adm = torch.maximum(h.ready_t, stall_rdy)
        if pol == _CYC or (pol == _ADS and cfg.admission):
            adm = torch.maximum(adm, ertw[None, :])
        can = (h.state == READY) & (adm <= h.tt[_T1_HI])
        own_freed = h.freed_t_p.index_select(1, parw_ix)

        free_p = h.seg_pw[_CAPS][None, :] - h.alloc_p
        stalled_p = stall_end > t1

        d_lad = None
        if pol in (_TP, _ADS):
            candw, syncw = h.candw, h.job_w[_SYNC]
            d_lad = (
                h.workw[..., None] / (torch.clamp(candw, min=1.0)[None, :, :] * tf)
                + h.iow[..., None]
                + syncw[None, :, None] * torch.clamp(candw - 1.0, min=0.0)[None, :, :]
            )
        h.put(adm=adm, can=can, own_freed=own_freed)
        return can, free_p, stalled_p, d_lad

    def cyc_policy():
        # runners keep their tiles until they finish: ready jobs bid
        # on *free* capacity only
        can, free_p, _, _ = policy_head()
        want = where0(can, h.seg_w[_PDOP][None, :].expand(R, W))
        h.put(free_p=free_p, want=want)

    def cyc_launch(perm):
        h.put(grant=edf_alloc(h.want, h.can, part_row(), h.seg_w[_PDOP][:, None],
                              h.free_p, perm))

    def tp_policy():
        # tp re-walks ready+running EDF against the *full* capacity
        # on every queue change; recomputing the fixed point each
        # round reproduces the event-driven walk
        can, _, stalled_p, d_lad = policy_head()
        t0, t1 = h.tt[_T0], h.tt[_T1]
        dop, pborn, rem, subb = window(F_DOP, F_PART, F_REM, F_SUB)
        run = h.run
        slack_rdy = h.seg_w[_SUB][None, :] - torch.clamp(h.adm, min=t0)
        want_rdy = where0(can, want_of(rem, slack_rdy, d_lad))
        rem_run = ((h.fin - t1) / torch.clamp(h.d_cur, min=1e-12)).clamp(0.0, 1.0)
        want_run_q = want_of(rem_run, subb - t1, d_lad)
        own_stalled = own_of(stalled_p, h.pborn_i, True)
        want_run = torch.where(own_stalled, dop, want_run_q)
        want = torch.where(run, want_run, want_rdy)
        h.put(want=want, entry=can | run, part=torch.where(run, pborn, part_row()))

    def tp_launch(perm):
        h.put(grant=edf_alloc(h.want, h.entry, h.part, h.candw, cap_pool(), perm,
                              bump=True))

    # ---- ads Algorithm 2, mirrored in two phases ------------------------
    def ads_part_a():
        return part_row().expand(R, W)

    def ads_policy():
        # Phase A (fast path): ready jobs start on *free* tiles at their
        # quota while running jobs hold their allocation
        can, free_p, stalled_p, d_lad = policy_head()
        slack_rdy = h.seg_w[_TGT][None, :] - torch.clamp(h.adm, min=h.tt[_T0])
        want_rdy = where0(can, want_of(h.win[F_REM], slack_rdy, d_lad))
        h.put(free_p=free_p, stalled_p=stalled_p, d_lad=d_lad, want_rdy=want_rdy)

    def ads_launch_a(perm):
        h.put(grantA=edf_alloc(h.want_rdy, h.can, ads_part_a(), h.candw, h.free_p, perm))

    def ads_bid():
        # ChkTrigger on the post-fast-path state; the running set is
        # the pre-start snapshot, as in the scalar policy.
        t1 = h.tt[_T1]
        dop, pborn, tgtb, adv = window(F_DOP, F_PART, F_TGT, F_ADV)
        can, run, pborn_i, parw_ix = h.can, h.run, h.pborn_i, h.parw_ix
        fin, d_cur, want_rdy, grantA = h.fin, h.d_cur, h.want_rdy, h.grantA
        cmaxw = h.candw[:, -1]
        started1 = can & (grantA > 0.5)
        alloc2 = h.alloc_p + per_part(started1, parw_ix[None, :], grantA)
        free2 = cap_pool() - alloc2
        still = can & ~started1
        own_free2 = free2.index_select(1, parw_ix)
        blocked = still & (want_rdy > own_free2 + 0.5)
        # progress is synced only at chunk boundaries and realloc
        # freezes: the projection runs on progress stale since the
        # last chunk boundary before t1 (only running jobs' value is read)
        if cfg.subrounds > 1:
            rem_stale = _stale_on_chunk_grid(fin, t1, adv, d_cur, cfg.n_chunks)
        else:
            # the reference loop's grid, anchored at ``adv`` (kept bit
            # for bit; see the module docstring)
            chunk_iv = torch.clamp(d_cur, min=1e-12) / float(cfg.n_chunks)
            stale_amt = where0(
                run, torch.remainder((t1 - adv).clamp(min=0.0), chunk_iv)
            )
            rem_stale = (
                ((fin - t1) + stale_amt) / torch.clamp(d_cur, min=1e-12)
            ).clamp(0.0, 1.0)
        at_risk = run & (cmaxw[None, :] > dop + 0.5) & (
            t1 + rem_stale * d_cur > tgtb
        )
        blocked_p = per_part(blocked, parw_ix[None, :])
        risk_p = per_part(at_risk, pborn_i)
        trig_p = (blocked_p | risk_p) & ~h.stalled_p
        own_trig_run = own_of(trig_p, pborn_i, False)
        own_trig_rdy = trig_p.index_select(1, parw_ix)

        # Phase B (quota control): triggered partitions re-bid
        # running + still-ready jobs EDF against the full capacity
        want_run_q = want_of(rem_stale, tgtb - t1, h.d_lad)
        entryB = (run & own_trig_run) | (still & own_trig_rdy)
        wantB = torch.where(run, torch.clamp(want_run_q, min=1.0), want_rdy)
        h.put(started1=started1, free2=free2, still=still, rem_stale=rem_stale,
              blocked_p=blocked_p, own_trig_run=own_trig_run,
              own_trig_rdy=own_trig_rdy, wantB=wantB, entryB=entryB,
              partB=torch.where(run, pborn, ads_part_a()))

    def ads_launch_b(perm):
        h.put(grantB=edf_alloc(h.wantB, h.entryB, h.partB, h.candw, cap_pool(), perm))

    def ads_gates():
        # benefit/cost gates: grow only when the saved time beats the
        # whole-partition stall it causes; shrink only to admit a
        # blocked job; never preempt a runner to zero.
        dop = h.win[F_DOP]
        run, pborn_i, grantB = h.run, h.pborn_i, h.grantB
        d_cur, own_trig_run = h.d_cur, h.own_trig_run
        d_new = dur(h.workw, h.iow, h.job_w[_SYNC], grantB)
        n_run_p = per_part(run, pborn_i, 1.0)
        own_nrun = own_of(n_run_p, pborn_i, 1.0)
        own_hops = h.seg_pw[_HOPS][pborn_i.clamp(0, P - 1)]
        stall_c = (
            cfg.fixed_s + cfg.decision_s + own_hops * cfg.per_hop_s
            + h.job_w[_CKPT][None, :] * torch.abs(grantB - dop) * cfg.inv_bw
        )
        benefit = h.rem_stale * (d_cur - d_new)
        grow_ok = benefit > stall_c * torch.clamp(own_nrun, min=1.0) * cfg.realloc_gate
        blocked_own = own_of(h.blocked_p, pborn_i, False)
        g = grantB
        g = torch.where(g > dop, torch.where(grow_ok, g, dop), g)
        g = torch.where((g < dop) & ~blocked_own, dop, g)
        g = torch.where(g < 0.5, dop, g)
        g = torch.where(run & own_trig_run, g, dop)

        # Phase B starts: validate against free + net freed tiles,
        # EDF order, dropping what no longer fits
        mB = run & own_trig_run
        freed_p = per_part(mB, pborn_i, torch.clamp(dop - g, min=0.0))
        grown_p = per_part(mB, pborn_i, torch.clamp(g - dop, min=0.0))
        availB = h.free2 + freed_p - grown_p
        dB = where0(h.still & h.own_trig_rdy, grantB)
        h.put(g=g, availB=availB, dB=dB)

    def ads_launch_keep(perm):
        h.put(started2=edf_start_keep(h.dB, ads_part_a(), h.availB, perm))

    # ---- apply ------------------------------------------------------------
    def apply(started, grant):
        """Starts, resizes and preempts, the tile-second buckets and the
        window's write-back; then the round counter moves on."""
        t0, t1 = h.tt[_T0], h.tt[_T1]
        state, fin = h.state, h.fin
        start, dop, pborn, rem, subb, tgtb, adv = window(
            F_START, F_DOP, F_PART, F_REM, F_SUB, F_TGT, F_ADV)
        run = h.run
        workw, iow, syncw, ckptw = h.workw, h.iow, h.job_w[_SYNC], h.job_w[_CKPT]
        _ertw, subw, tgtw, _pdw, parw = h.seg_w.unbind(0)
        hopsg = h.seg_pw[_HOPS]
        # a job admitted before this round opened was blocked on
        # capacity; it starts at the in-round release event, not at adm
        d_start = dur(workw, iow, syncw, grant)
        start_t = torch.where(
            h.adm >= h.tt[_T0_LO], h.adm, torch.clamp(h.own_freed, min=t0, max=t1),
        )
        state = torch.where(started, RUN, state)
        start = torch.where(started, start_t, start)
        fin = torch.where(started, start_t + rem * d_start, fin)
        pborn = torch.where(started, parw[None, :], pborn)
        subb = torch.where(started, subw[None, :], subb)
        tgtb = torch.where(started, tgtw[None, :], tgtb)

        # ---- apply: resizes / preempts (tp, ads) ---------------------
        if pol in (_TP, _ADS):
            resized = run & (torch.abs(grant - dop) > 0.5)
            if pol == _TP:
                preempt = resized & (grant < 0.5)
            else:
                preempt = torch.zeros_like(resized)
            moved_j = where0(
                resized,
                ckptw[None, :] * torch.where(preempt, dop, torch.abs(grant - dop)),
            )
            ohres = pborn.to(_I64)[..., None] == ar_p
            moved_p = torch.where(ohres, moved_j[..., None], 0.0).sum(dim=1)
            changed_p = (resized[..., None] & ohres).any(dim=1)
            stall_p = torch.where(
                changed_p,
                cfg.fixed_s + cfg.decision_s + hopsg[None, :] * cfg.per_hop_s
                + moved_p * cfg.inv_bw,
                0.0,
            )
            stall_end.copy_(torch.maximum(stall_end, t1 + stall_p))
            rem_now = ((fin - t1) / torch.clamp(h.d_cur, min=1e-12)).clamp(0.0, 1.0)
            d_res = dur(workw, iow, syncw, grant)
            keep = resized & ~preempt
            fin = torch.where(keep, t1 + rem_now * d_res, fin)
            dop = torch.where(keep, grant, dop)
            rem = torch.where(preempt, rem_now, rem)
            state = torch.where(preempt, READY, state)
            dop = where0(~preempt, dop)
            fin = torch.where(preempt, INFW, fin)
            # whole-partition freeze: survivors wait out the stall
            stall_own = torch.gather(
                torch.cat([stall_p, ZP1], dim=1), 1,
                pborn.to(_I64).clamp(0, P),
            )
            frozen = (state == RUN) & ~started & (stall_own > 0)
            fin = torch.where(frozen, fin + stall_own, fin)
            # the freeze is where the scalar engine syncs progress: the
            # staleness clock restarts at the stall's end
            adv = torch.where(frozen | keep, t1 + stall_own, adv)
            n_changed = changed_p.to(_F32).sum(dim=1)
            nre.add_(n_changed)
            if nre_sub is not None:
                nre_sub.add_(n_changed * (rnd.remainder(cfg.subrounds) > 0))
            rbytes.add_(moved_p.sum(dim=1))

        dop = torch.where(started, grant, dop)
        adv = torch.where(started, start_t, adv)

        # ---- accumulate tile-seconds into the segment buckets --------
        start_corr = where0(
            started, grant * (t1 - start_t).clamp(min=0.0)
        ).sum(dim=1)
        busy_r = (h.presence + start_corr - h.realloc_r).clamp(min=0.0)
        busy.index_add_(1, h.sg, busy_r[:, None])
        rel.index_add_(1, h.sg, h.realloc_r[:, None])

        # ---- write the window back (in place) ------------------------
        new_w = (state, h.ready_t, h.deg, start, fin, dop, pborn, rem, subb,
                 tgtb, adv)
        planes.index_copy_(2, h.idx, torch.stack(new_w))
        rnd.add_(1)

    def apply_granted():
        apply(h.can & (h.grant > 0.5), h.grant)

    def ads_apply():
        started1, started2 = h.started1, h.started2
        started = started1 | started2
        grant = torch.where(
            h.run, h.g,
            torch.where(started1, h.grantA, where0(started2, h.grantB)),
        )
        apply(started, grant)

    # the steps tile the round: ``soa_round.resolve`` (its span opened by
    # the loop), ``.policy`` through the last launch, ``.apply``
    if pol == _ADS:
        steps = [(None, resolve, None),
                 ("soa_round.policy", ads_policy, ads_launch_a),
                 (None, ads_bid, ads_launch_b),
                 (None, ads_gates, ads_launch_keep),
                 ("soa_round.apply", ads_apply, None)]
    else:
        policy, launch = (tp_policy, tp_launch) if pol == _TP else (cyc_policy, cyc_launch)
        steps = [(None, resolve, None),
                 ("soa_round.policy", policy, launch),
                 ("soa_round.apply", apply_granted, None)]
    return _Body(steps=steps, seam=seam, handoff=h,
                 out=(planes, codes, stall_end, busy, rel, nre, rbytes, dwork, nre_sub))


def _capture(body: _Body, dev: torch.device, pool) -> list:
    """One CUDA graph per step of the round, captured on a side stream
    into ``pool`` (nothing runs; the handoff takes the graphs'
    outputs)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.Stream()
    graphs = []
    body.handoff.capturing = True
    try:
        with torch.cuda.stream(stream):
            for _span, step, _launch in body.steps:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool.id)
                step()
                g.capture_end()
                graphs.append(g)
    finally:
        body.handoff.capturing = False
    return graphs


def _run_rounds(cfg: KernelConfig, host, dc, work, io, codes):
    """Advance every lane through every round; returns the final state
    planes and accumulators (tensors on ``work``'s device).

    On the CPU every round runs the steps of :func:`_round_body` eagerly.
    On the card (where ``dc["graph_pool"]`` holds the memory pool that
    :func:`simulate` made for the loop) round 0 does too; then each step
    is captured as a CUDA graph into that pool and every later round
    replays them, the allocator's launches issued eagerly between the
    replays.  The graphs are released when the loop returns, the pool by
    :func:`simulate` once the card is idle."""
    n_rounds = int(host["t0"].shape[0])
    body = _round_body(cfg, dc, work, io, codes)
    pool = dc.get("graph_pool")
    graphs = None

    # host-side phases of the round, when the registry is on: ``seam``
    # (on a seam round, the hot-swap), ``resolve``, ``policy`` (through
    # the last allocator launch), ``apply``; they tile the round with no
    # gap.  The capture, after round 0, is phase ``soa_capture``.
    seq = metrics.active_seq()
    seams = (np.asarray(host["entry"], dtype=bool)
             & np.asarray(host["swap"], dtype=bool)[host["seg"].astype(np.int64)])
    try:
        for r in range(n_rounds):
            if seq:
                seq.enter("soa_round.seam" if seams[r] else "soa_round.resolve")
            # ---- seam hot-swap (rare; only at segment-entry rounds) --
            if seams[r]:
                body.seam(int(host["lo"][r]), int(host["seg"][r]), float(host["t0"][r]))
                if seq:
                    seq.enter("soa_round.resolve")
            perm = dc["perm"][r]
            for i, (span, step, launch) in enumerate(body.steps):
                if span and seq:
                    seq.enter(span)
                if graphs is None:
                    step()
                else:
                    graphs[i].replay()
                if launch is not None:
                    launch(perm)
            if graphs is not None:
                metrics.count("soa_graph_rounds")
            elif pool is not None and r + 1 < n_rounds:
                if seq:
                    seq.close()
                with metrics.phase("soa_capture"):
                    graphs = _capture(body, work.device, pool)
                metrics.count("soa_graph_captures")
    finally:
        for g in graphs or ():
            g.reset()
    return body.out


@contextlib.contextmanager
def _cuda_loop_guard(dev: torch.device):
    """On the card, any host sync inside the loop is an error."""
    if dev.type != "cuda":
        yield
        return
    sync = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(sync)


def simulate(
    cfg: KernelConfig,
    const_np: Dict[str, np.ndarray],
    lanes_np: Dict[str, np.ndarray],
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Run the round loop on ``device``; returns the final state as
    NumPy arrays.

    ``const_np`` holds the host-precomputed statics (see
    :func:`repro_torch.core.sim.soa.build_problem`), ``lanes_np`` the
    per-lane trace data (``work``, ``io``, ``codes0``).  Everything is
    uploaded before round 0; the loop itself never waits on the card.
    """
    dev = resolve_device(device)
    R, N = lanes_np["work"].shape
    if R != cfg.R:
        raise ValueError(f"config for R={cfg.R}, lanes hold {R}")

    def lane(k):
        return torch.from_numpy(
            np.ascontiguousarray(lanes_np[k], dtype=np.float32)
        ).to(dev)

    with metrics.phase("soa_stage"):
        host = {k: np.asarray(const_np[k]) for k in _HOST_KEYS}
        dc = _upload(const_np, dev)
        dc.update(_round_tables(host, dev))
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                dc["graph_pool"] = torch.cuda.MemPool()
        work, io, codes = lane("work"), lane("io"), lane("codes0").clone()
    with _cuda_loop_guard(dev), metrics.phase("soa_issue"), metrics.phase_seq():
        st, codes, stall_end, busy, rel, nre, rbytes, dwork, nre_sub = _run_rounds(
            cfg, host, dc, work, io, codes
        )

    def f4(t):
        return t.cpu().numpy()

    def f8(t):
        return t.cpu().numpy().astype(np.float64)

    # the first copy waits for the card to finish every round; then the
    # loop's graph pool goes back to the device, the card idle
    with metrics.phase("soa_drain"):
        out = {
            "state": f4(st[F_STATE]),
            "ready_t": f4(st[F_READY]),
            "deg": f4(st[F_DEG]),
            "start": f4(st[F_START]),
            "fin": f4(st[F_FIN]),
            "dop": f4(st[F_DOP]),
            "codes": f4(codes),
            "busy": f8(busy),
            "realloc": f8(rel),
            "n_realloc": f8(nre),
            "realloc_bytes": f8(rbytes),
            "dropped_work": f8(dwork),
        }
        if nre_sub is not None:
            out["n_realloc_sub"] = f8(nre_sub)
        dc.pop("graph_pool", None)
    return out
