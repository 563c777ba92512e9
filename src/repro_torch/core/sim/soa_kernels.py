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

* the round index, window bounds, segment and seam flags are host
  NumPy values, so the seam step is a Python ``if`` and every window is
  plain slicing; the state planes and finish codes are updated in
  place, one ``(R, W)`` window per round;
* the allocator's convergence-gated ``while_loop``s run a fixed trip
  count (``1 + alloc_iters`` / ``1 + bump_passes``): the refinement
  maps are idempotent once converged, so the result is the same and no
  round needs a host sync;
* the ladder-grant select is :func:`ladder_grant`: a hand-written CUDA
  kernel (``csrc/ladder_grant.cu``) for tensors on the card, its plain
  PyTorch version :func:`_ladder_grant` for tensors on the CPU.
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


_LADDER_SIG = {
    "ladder_grant": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]),
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


def _class_prefix(cfg, part_s, cap_p):
    """Per-partition queue-prefix operators for one sorted queue.

    Returns ``(excl, total, capg)``: ``excl(d)`` is each entry's
    exclusive prefix sum of ``d`` over earlier same-partition entries,
    ``total(d)`` the inclusive whole-partition sum seen by each entry,
    and ``capg`` the entry's own partition budget.  With one partition
    these are a plain cumsum / broadcast sum; multi-partition uses a
    same-partition strict-lower mask as a batched matvec (full float32:
    the caller disables TF32, the operands are small integer tile
    counts and must sum exactly)."""
    if cfg.P == 1:
        capg = cap_p[:, :1].expand(part_s.shape)

        def excl(d):
            return torch.cumsum(d, dim=1) - d

        def total(d):
            return d.sum(dim=1, keepdim=True).expand(d.shape)

        return excl, total, capg

    part_i = part_s.to(torch.int64).clamp(0, cfg.P - 1)
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


def _alloc_ladder(cfg, want, entry, part_s, cand_s, cap_p):
    """Feasible EDF ladder allocation over one round's sorted queue.

    ``want``: (R, W) desired DoP per queue entry (EDF order);
    ``entry``: (R, W) bool participation mask; ``part_s``: (R, W)
    partition id per entry; ``cand_s``: (W, C) candidate rows;
    ``cap_p``: (R, P) tile budget per partition.

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
    excl, _, capg = _class_prefix(cfg, part_s, cap_p)
    cand_s = cand_s.contiguous()
    cur = want
    for _ in range(1 + cfg.alloc_iters):
        limit = torch.minimum(want, capg - excl(cur)).contiguous()
        cur = torch.where(entry, ladder_grant(limit, cand_s), zero)
    return cur


def _bump_work_conserving(cfg, grant, entry, part_s, cand_s, cap_p):
    """tp_driven's saturation pass: spend leftover tiles by bumping
    queue entries (EDF order) to their next candidate rung.  Each pass
    assumes every earlier eligible entry takes its bump, so it never
    over-commits.  ``1 + bump_passes`` passes, by the same idempotence
    argument as :func:`_alloc_ladder`."""
    excl, total, capg = _class_prefix(cfg, part_s, cap_p)

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

    for _ in range(1 + cfg.bump_passes):
        grant = one_pass(grant)
    return grant


# ---------------------------------------------------------------------------
# the round loop
# ---------------------------------------------------------------------------
_HOST_KEYS = ("t0", "t1", "seg", "lo", "entry", "swap")


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


def _run_rounds(cfg: KernelConfig, host, dc, work, io, codes):
    """Advance every lane through every round; returns the final state
    planes and accumulators (tensors on ``work``'s device)."""
    R, W, P, C, PM = cfg.R, cfg.W, cfg.P, cfg.C, cfg.PM
    tf = cfg.tile_flops
    pol = cfg.policy
    dev = work.device
    N = work.shape[1]
    S_ = int(dc["caps"].shape[0])
    n_rounds = int(host["t0"].shape[0])

    def zeros(shape):
        return torch.zeros(shape, dtype=_F32, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=_F32, device=dev)

    fills = {F_FIN: float("inf"), F_SUB: float("inf"), F_TGT: float("inf"),
             F_PART: -1.0, F_REM: 1.0}
    st = [full((R, N), fills.get(f, 0.0)) for f in range(NFIELDS)]
    stall_end = zeros((R, P))
    busy = zeros((R, S_))
    rel = zeros((R, S_))
    nre = zeros((R,))
    rbytes = zeros((R,))
    dwork = zeros((R,))

    ZW = zeros((R, W))
    INFW = full((R, W), float("inf"))
    ar_p = torch.arange(P, dtype=torch.int64, device=dev)
    pos = torch.arange(W, dtype=_F32, device=dev)
    ZP1 = zeros((R, 1))
    part_ix = dc["part"].to(torch.int64).clamp(0, P - 1)

    def dur(work, io, sync, c):
        cc = torch.clamp(c, min=1.0)
        return work / (cc * tf) + io + sync * (cc - 1.0)

    def where0(m, v):
        return torch.where(m, v, ZW)

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

    for r in range(n_rounds):
        t0 = float(host["t0"][r])
        t1 = float(host["t1"][r])
        sg = int(host["seg"][r])
        lo = int(host["lo"][r])
        hi = lo + W

        # windows are views; the planes are only written at the end of
        # the round, after every read of this round's window
        (state, ready_t, deg, start, fin, dop, pborn, rem, subb, tgtb,
         adv) = (a[:, lo:hi] for a in st)

        relw = dc["release"][lo:hi]
        e2ew = dc["e2e"][lo:hi]
        syncw = dc["sync"][lo:hi]
        ckptw = dc["ckpt"][lo:hi]
        predw = dc["preds"][lo:hi]
        workw = work[:, lo:hi]
        iow = io[:, lo:hi]
        ertw = dc["ert"][sg, lo:hi]
        subw = dc["sub"][sg, lo:hi]
        tgtw = dc["tgt"][sg, lo:hi]
        pdw = dc["pdop"][sg, lo:hi]
        parw = dc["part"][sg, lo:hi]
        parw_ix = part_ix[sg, lo:hi]
        candw = dc["cands"][sg, lo:hi]
        capsg = dc["caps"][sg]
        hopsg = dc["hops"][sg]
        stagedg = dc["staged"][sg]
        permr = dc["perm"][r]
        ipermr = dc["iperm"][r]

        # ---- seam hot-swap (rare; only at segment-entry rounds) ------
        if host["entry"][r] and host["swap"][sg]:
            state, fin, dop, rem, adv, stall_end, nre, rbytes = seam_step(
                state, fin, dop, rem, adv, pborn, stall_end, nre, rbytes,
                t0, workw, iow, syncw, ckptw, capsg, hopsg, stagedg,
            )
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
        dwork = dwork + where0(dropping, rem_d * d_plan * pdw[None, :]).sum(dim=1)
        state = torch.where(dropping, DROP, state)
        fin = torch.where(dropping, droptime, fin)
        deg = torch.where(dropping, 1.0, deg)

        # in-round capacity-release times per partition: a job that sat
        # queued through earlier rounds can only start at the event that
        # made room (a completion or drop), never back at its admission
        # time
        fpart = torch.where(drop_rdy, parw[None, :], pborn).to(torch.int64)
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
        codes[:, lo:hi] = code_w  # in place: one window per round

        # ---- accounting: tile presence of the pre-policy state -------
        run = state == RUN
        pborn_i = pborn.to(torch.int64)
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

        # ---- policy pass ---------------------------------------------
        stall_rdy = stall_end.index_select(1, parw_ix)
        adm = torch.maximum(ready_t, stall_rdy)
        if pol == _CYC or (pol == _ADS and cfg.admission):
            adm = torch.maximum(adm, ertw[None, :])
        can = (state == READY) & (adm <= t1 + 1e-12)
        own_freed = freed_t_p.index_select(1, parw_ix)

        free_p = capsg[None, :] - alloc_p
        stalled_p = stall_end > t1

        if pol in (_TP, _ADS):
            d_lad = (
                workw[..., None] / (torch.clamp(candw, min=1.0)[None, :, :] * tf)
                + iow[..., None]
                + syncw[None, :, None] * torch.clamp(candw - 1.0, min=0.0)[None, :, :]
            )

        def want_of(rem_f, slack):
            """fit_quota's ladder target with no tile cap (cap folds in
            at grant time): smallest candidate meeting the deadline,
            else the largest rung."""
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

        def edf_alloc(want_m, entry_m, part_m, cand_rows, pool, bump=False):
            """EDF-permute, ladder-allocate, inverse-permute."""
            want_s = want_m.index_select(1, permr)
            entry_s = entry_m.index_select(1, permr)
            part_s = part_m.expand(R, W).index_select(1, permr)
            cand_s = cand_rows.index_select(0, permr)
            grant_s = _alloc_ladder(cfg, want_s, entry_s, part_s, cand_s, pool)
            if bump:
                grant_s = _bump_work_conserving(
                    cfg, grant_s, entry_s, part_s, cand_s, pool
                )
            return grant_s.index_select(1, ipermr)

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

        cap_pool = capsg[None, :].expand(R, P)
        if pol in (_CYC, _CYC_S):
            # runners keep their tiles until they finish: ready jobs bid
            # on *free* capacity only
            want = where0(can, pdw[None, :].expand(R, W))
            grant = edf_alloc(want, can, parw[None, :], pdw[:, None], free_p)
            started = can & (grant > 0.5)
        elif pol == _TP:
            # tp re-walks ready+running EDF against the *full* capacity
            # on every queue change; recomputing the fixed point each
            # round reproduces the event-driven walk
            slack_rdy = subw[None, :] - torch.clamp(adm, min=t0)
            want_rdy = where0(can, want_of(rem, slack_rdy))
            rem_run = ((fin - t1) / torch.clamp(d_cur, min=1e-12)).clamp(0.0, 1.0)
            want_run_q = want_of(rem_run, subb - t1)
            own_stalled = own_of(stalled_p, pborn_i, True)
            want_run = torch.where(own_stalled, dop, want_run_q)
            want = torch.where(run, want_run, want_rdy)
            grant = edf_alloc(
                want, can | run, torch.where(run, pborn, parw[None, :]),
                candw, cap_pool, bump=True,
            )
            started = can & (grant > 0.5)
        else:
            # ---- ads Algorithm 2, mirrored in two phases --------------
            # Phase A (fast path): ready jobs start on *free* tiles at
            # their quota while running jobs hold their allocation
            cmaxw = candw[:, -1]
            slack_rdy = tgtw[None, :] - torch.clamp(adm, min=t0)
            want_rdy = where0(can, want_of(rem, slack_rdy))
            partA = parw[None, :].expand(R, W)
            grantA = edf_alloc(want_rdy, can, partA, candw, free_p)
            started1 = can & (grantA > 0.5)

            # ChkTrigger on the post-fast-path state; the running set is
            # the pre-start snapshot, as in the scalar policy.
            alloc2 = alloc_p + per_part(started1, parw_ix[None, :], grantA)
            free2 = cap_pool - alloc2
            still = can & ~started1
            own_free2 = free2.index_select(1, parw_ix)
            blocked = still & (want_rdy > own_free2 + 0.5)
            # progress is synced only at chunk boundaries and realloc
            # freezes: the projection runs on progress stale since the
            # last chunk boundary before t1 (``adv`` anchors the grid)
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
            trig_p = (blocked_p | risk_p) & ~stalled_p
            own_trig_run = own_of(trig_p, pborn_i, False)
            own_trig_rdy = trig_p.index_select(1, parw_ix)

            # Phase B (quota control): triggered partitions re-bid
            # running + still-ready jobs EDF against the full capacity
            want_run_q = want_of(rem_stale, tgtb - t1)
            entryB = (run & own_trig_run) | (still & own_trig_rdy)
            wantB = torch.where(run, torch.clamp(want_run_q, min=1.0), want_rdy)
            grantB = edf_alloc(
                wantB, entryB, torch.where(run, pborn, partA), candw, cap_pool
            )

            # benefit/cost gates: grow only when the saved time beats the
            # whole-partition stall it causes; shrink only to admit a
            # blocked job; never preempt a runner to zero.
            d_new = dur(workw, iow, syncw, grantB)
            n_run_p = per_part(run, pborn_i, 1.0)
            own_nrun = own_of(n_run_p, pborn_i, 1.0)
            own_hops = hopsg[pborn_i.clamp(0, P - 1)]
            stall_c = (
                cfg.fixed_s + cfg.decision_s + own_hops * cfg.per_hop_s
                + ckptw[None, :] * torch.abs(grantB - dop) * cfg.inv_bw
            )
            benefit = rem_stale * (d_cur - d_new)
            grow_ok = benefit > stall_c * torch.clamp(own_nrun, min=1.0) * cfg.realloc_gate
            blocked_own = own_of(blocked_p, pborn_i, False)
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
            availB = free2 + freed_p - grown_p
            dB = where0(still & own_trig_rdy, grantB)
            dB_s = dB.index_select(1, permr)
            exclB, _, availg = _class_prefix(
                cfg, partA.index_select(1, permr), availB
            )
            keep_s = (dB_s > 0) & (exclB(dB_s) + dB_s <= availg + 0.5)
            started2 = keep_s.index_select(1, ipermr)
            started = started1 | started2
            grant = torch.where(
                run, g,
                torch.where(started1, grantA, where0(started2, grantB)),
            )

        # ---- apply: starts -------------------------------------------
        # a job admitted before this round opened was blocked on
        # capacity; it starts at the in-round release event, not at adm
        d_start = dur(workw, iow, syncw, grant)
        start_t = torch.where(
            adm >= t0 - 1e-9, adm, torch.clamp(own_freed, min=t0, max=t1),
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
            ohres = pborn.to(torch.int64)[..., None] == ar_p
            moved_p = torch.where(ohres, moved_j[..., None], 0.0).sum(dim=1)
            changed_p = (resized[..., None] & ohres).any(dim=1)
            stall_p = torch.where(
                changed_p,
                cfg.fixed_s + cfg.decision_s + hopsg[None, :] * cfg.per_hop_s
                + moved_p * cfg.inv_bw,
                0.0,
            )
            stall_end = torch.maximum(stall_end, t1 + stall_p)
            rem_now = ((fin - t1) / torch.clamp(d_cur, min=1e-12)).clamp(0.0, 1.0)
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
                pborn.to(torch.int64).clamp(0, P),
            )
            frozen = (state == RUN) & ~started & (stall_own > 0)
            fin = torch.where(frozen, fin + stall_own, fin)
            # the freeze is where the scalar engine syncs progress: the
            # staleness clock restarts at the stall's end
            adv = torch.where(frozen | keep, t1 + stall_own, adv)
            nre = nre + changed_p.to(_F32).sum(dim=1)
            rbytes = rbytes + moved_p.sum(dim=1)

        dop = torch.where(started, grant, dop)
        adv = torch.where(started, start_t, adv)

        # ---- accumulate tile-seconds into the segment buckets --------
        start_corr = where0(
            started, grant * (t1 - start_t).clamp(min=0.0)
        ).sum(dim=1)
        busy_r = (presence + start_corr - realloc_r).clamp(min=0.0)
        busy[:, sg] += busy_r
        rel[:, sg] += realloc_r

        # ---- write the window back (in place) ------------------------
        new_w = (state, ready_t, deg, start, fin, dop, pborn, rem, subb,
                 tgtb, adv)
        for a, w in zip(st, new_w):
            a[:, lo:hi] = w
    return st, codes, stall_end, busy, rel, nre, rbytes, dwork


@contextlib.contextmanager
def _cuda_loop_guard(dev: torch.device):
    """On the card: full-float32 matmuls (the prefix operators compare
    integer tile sums against +0.5 margins; TF32 keeps ~3 digits), and
    any host sync inside the loop is an error."""
    if dev.type != "cuda":
        yield
        return
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    sync = torch.cuda.get_sync_debug_mode()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(sync)
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
    host = {k: np.asarray(const_np[k]) for k in _HOST_KEYS}
    dc = _upload(const_np, dev)

    def lane(k):
        return torch.from_numpy(
            np.ascontiguousarray(lanes_np[k], dtype=np.float32)
        ).to(dev)

    work, io, codes = lane("work"), lane("io"), lane("codes0").clone()
    with _cuda_loop_guard(dev):
        st, codes, stall_end, busy, rel, nre, rbytes, dwork = _run_rounds(
            cfg, host, dc, work, io, codes
        )

    def f4(t):
        return t.cpu().numpy()

    def f8(t):
        return t.cpu().numpy().astype(np.float64)

    return {
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
