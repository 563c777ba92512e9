"""Structure-of-arrays Monte-Carlo backend: host orchestration.

This module turns one scenario cell — (workflow, scenario, schedule
portfolio, policy, horizon) — into a *SoA problem*: the set of
lane-independent arrays that :mod:`repro_torch.core.sim.soa_kernels` advances
for **R seeds simultaneously**.  The division of labour:

* **host (here, NumPy)** — job ordering (release-sorted), dependency
  columns into the finish-code array, the discrete round grid
  (seam-aligned, ``SoaOptions.dt_s`` cadence), per-round active job
  windows, per-round EDF permutations, per-segment schedule bindings
  (ERT / sub-deadline / slack-shared target / planned DoP / partition /
  DoP-candidate ladders), hot-swap capacities and staging volumes, and
  — after the kernel returns — assembly of one
  :class:`~repro_torch.core.sim.engine.SimReport` per lane;
* **device (torch, on the card by default)** — everything per-lane:
  readiness, drops, policy quota/EDF decisions, reallocation stalls,
  tile-second accounting.

Fidelity contract (enforced by ``tests/test_torch_soa.py`` against the
JAX reference's scalar engine): the scalar engine remains
the semantics oracle; this backend reproduces it **distributionally**
(KS on chain-latency distributions, CI agreement on violation rate /
realloc waste / tiles reserved) and **exactly** on structural
invariants (job counts, seam times/spans, chain universe).  The known
approximations — discrete scheduling rounds instead of an event heap,
bounded fixed-point allocation passes instead of the exact sequential
queue walk, current-segment deadline bindings for not-yet-started
straddlers — are documented in ``docs/performance.md#soa-backend``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...obs import metrics
from .engine import ModeStats, SimReport
from .trace import build_skeleton
from . import soa_kernels as K

__all__ = [
    "SoaOptions",
    "SoaUnsupported",
    "SoaWindowOverflow",
    "soa_available",
    "soa_supported",
    "build_problem",
    "problem_from_arrays",
    "run_problem",
    "ks_statistic",
    "mean_ci",
    "intervals_overlap",
    "structural_invariants",
]

_TOL = 1e-9


def soa_available() -> bool:
    """True: the backend needs torch only, which this package imports.
    (Whether a CUDA device is present is the caller's ``device``
    choice, not an availability question: a missing card raises.)"""
    return True


class SoaUnsupported(ValueError):
    """The requested cell is outside the SoA backend's support set."""


class SoaWindowOverflow(SoaUnsupported):
    """A job slid out of the sliding job window still unresolved.

    The window lifetime bound assumes every job resolves within its E2E
    deadline plus the drop-cascade slack; under ``drop_policy="soft"``
    (the runner's default) an overloaded cell legally queues/runs jobs
    past their E2E deadline, and a job that exits the window while
    still PEND/READY/RUN would silently freeze — counted as a miss with
    all its successors starved.  :func:`run_problem` detects this on
    the final state planes and raises instead of returning truncated
    results; callers either widen :attr:`SoaOptions.life_pad_s` (the
    runner's SoA path (``run(spec, seeds=..., backend="soa")``)
    retries with a doubled window automatically) or use the scalar
    engine.
    """


def soa_supported(
    policy: str,
    replan_mode: str = "reactive",
    detection_delay_s: float = 0.0,
    drop_policy: str = "soft",
    record: bool = False,
) -> bool:
    """Support predicate mirroring ``batch.fast_lane_supported``'s role:
    the SoA kernels cover the three paper policies (+ elastic cyc) with
    reactive zero-delay replanning under both drop policies; anything
    else (predictive replanning, recorders) must run on the scalar
    engine."""
    return (
        policy in K.POLICY_IDS
        and replan_mode == "reactive"
        and abs(detection_delay_s) < _TOL
        and drop_policy in ("soft", "hard")
        and not record
    )


def _drop_mode(policy_name: str, drop_policy: str) -> int:
    """Map (policy, drop_policy) onto the kernel's drop regime.  cyc
    terminates budget overruns at the sub-deadline unconditionally; the
    elastic/tp/ads policies only arm e2e dequeue timers under
    ``drop_policy="hard"`` (the scenario runner defaults to soft)."""
    if policy_name == "cyc":
        return 1
    return 2 if drop_policy == "hard" else 0


@dataclasses.dataclass(frozen=True)
class SoaOptions:
    """Tuning knobs of the discrete-round approximation.

    ``dt_s`` is the scheduling-round cadence: smaller tracks the scalar
    engine's event cadence more closely (the bundled workloads see
    ~one scheduling event per partition per 2-4 ms), larger is faster.
    Event *times* are exact regardless (backdated); dt only quantizes
    when decisions are taken.
    """

    dt_s: float = 1e-3
    window_round: int = 16      # round the job window up to a multiple
    #: extra seconds added to the job-window lifetime bound (how long a
    #: job may stay unresolved past its release before it slides out of
    #: the window).  The default bound assumes jobs resolve by their
    #: E2E deadline; under ``drop_policy="soft"`` overload queues jobs
    #: past it — :class:`SoaWindowOverflow` reports when the bound was
    #: too tight and the runner retries with a doubled window.  The
    #: effective lifetime is capped at the horizon (full coverage).
    life_pad_s: float = 0.0
    #: EDF fixed-point refinement steps; None resolves per policy —
    #: tp_driven's event walk needs the exact sequential fixed point
    #: (8), cyc/ads converge by 3 (measured KS-identical vs 8)
    alloc_iters: Optional[int] = None
    bump_passes: int = 8        # tp work-conserving refinement steps


@dataclasses.dataclass
class SoaProblem:
    """One compiled-shape scenario cell plus report-assembly side data."""

    cfg: K.KernelConfig
    const: Dict[str, np.ndarray]
    # job-axis mapping
    jids: np.ndarray            # soa pos -> global skeleton jid (real jobs)
    n_real: int
    n_pad: int
    sen_jids: np.ndarray
    sen_release: np.ndarray
    sen_drop: np.ndarray
    # report side data
    duration: float
    num_tiles: int
    considered: np.ndarray      # (n_pad,) bool
    e2e_host: np.ndarray        # (n_pad,) float64 exact
    sinks: List[Tuple[str, int, float, float, str]]  # (chain, pos, t0, ddl, mode)
    chain_names: List[str]
    expected: Dict[str, int]
    expected_mode: Dict[str, Dict[str, int]]
    mode_order: List[str]
    seg_mode: List[str]
    seg_span: List[Tuple[float, float]]
    spans: Dict[str, float]
    n_mode_switches: int
    tiles_used: int
    tiles_reserved_mean: float
    frontier_meta: Dict[str, object]
    skeleton_key: tuple
    life: float                 # job-window lifetime bound (seconds)
    win_lo_final: int           # highest window lower bound over rounds


def _policy_knobs(policy) -> Tuple[bool, bool, bool, float]:
    """(admission, quota_control, slack_sharing, realloc_gate) of a
    policy *instance* (ads ablation flags ride into the kernel config)."""
    return (
        bool(getattr(policy, "admission", True)),
        bool(getattr(policy, "quota_control", True)),
        bool(getattr(policy, "slack_sharing", True)),
        float(getattr(policy, "realloc_gate", 1.0)),
    )


def _downstream_budget(wf, sched) -> Dict[str, float]:
    """ads slack sharing: tightest downstream budget per task under one
    table (AdsTilePolicy.setup's ``_down``)."""
    down: Dict[str, float] = {}
    for t, task in wf.tasks.items():
        if task.is_sensor:
            continue
        tight = math.inf
        for chain in wf.chain_for(t):
            i = chain.nodes.index(t)
            after = [
                n for n in chain.nodes[i + 1:] if not wf.tasks[n].is_sensor
            ]
            tight = min(tight, sum(sched.plans[n].budget_s for n in after))
        down[t] = 0.0 if tight is math.inf else tight
    return down


def _candidate_table(wf, sched, policy_name) -> Dict[str, Tuple[int, ...]]:
    """Per-task DoP ladders as the policy instance would resolve them:
    ads follows an autotuned table's compiled candidate set
    (``meta["task_dop_candidates"]``), tp always uses the workload
    ladder, cyc only ever uses the planned DoP."""
    src = sched.meta.get("task_dop_candidates") if policy_name == "ads_tile" else None
    out = {}
    for name, t in wf.tasks.items():
        if t.is_sensor:
            continue
        if src is not None:
            out[name] = tuple(src.get(name, t.dop_candidates()))
        else:
            out[name] = t.dop_candidates()
    return out


def _segments(scenario, duration, schedule0, portfolio, replan):
    """Scenario boundary spans clipped to the horizon, each carrying the
    schedule table active during it and whether its entry performs a
    hot-swap (mirrors the reactive replanner: swap only when the
    portfolio's table for the new mode differs from the active one)."""
    bounds = list(scenario.boundaries())
    segs = []
    active = schedule0
    for i, (t, m) in enumerate(bounds):
        if t >= duration - _TOL and i > 0:
            break
        t_end = bounds[i + 1][0] if i + 1 < len(bounds) else max(duration, t)
        t_end = min(t_end, duration)
        swap = False
        if i > 0 and replan and portfolio is not None:
            tbl = portfolio.get(m)
            if tbl is not None and tbl is not active:
                active = tbl
                swap = True
        segs.append((max(0.0, t), t_end, m, active, swap))
    return segs


def _plan_deltas_staged(wf, old, new, P) -> np.ndarray:
    """Hot-swap stage-in volume per *target* partition (engine
    ``_plan_deltas``): full checkpoint x dop on a partition move, the
    L2P minimal checkpoint x |dop delta| on a DoP change in place."""
    staged = np.zeros(P, dtype=np.float64)
    for task, np_plan in new.plans.items():
        op = old.plans.get(task)
        if op is None:
            continue
        ckpt = wf.tasks[task].checkpoint_bytes
        if np_plan.partition != op.partition:
            staged[np_plan.partition] += ckpt * np_plan.dop
        elif np_plan.dop != op.dop:
            staged[np_plan.partition] += ckpt * abs(np_plan.dop - op.dop)
    return staged


def build_problem(
    wf,
    model,
    schedule0,
    portfolio,
    policy,
    scenario,
    duration: float,
    replan: bool = True,
    n_lanes: int = 8,
    drop_policy: str = "soft",
    options: Optional[SoaOptions] = None,
) -> SoaProblem:
    """Precompute one scenario cell's lane-independent arrays.

    ``policy`` may be a policy instance (ads ablation flags are read
    off it) or a policy name string.
    """
    opt = options or SoaOptions()
    hw = model.hw
    policy_name = policy if isinstance(policy, str) else policy.name
    if policy_name not in K.POLICY_IDS:
        raise SoaUnsupported(f"policy {policy_name!r} not supported by soa")
    admission, quota_control, slack_sharing, gate = (
        (True, True, True, 1.0)
        if isinstance(policy, str)
        else _policy_knobs(policy)
    )
    if getattr(policy, "drop_on_subddl", False):
        raise SoaUnsupported("tp_driven drop_on_subddl is scalar-only")

    skel = build_skeleton(wf, scenario, duration)
    rel_all = np.asarray(skel.release, dtype=np.float64)
    dnn = np.asarray(skel.dnn_ix, dtype=np.int64)
    sen = np.asarray(skel.sen_ix, dtype=np.int64)

    order = np.lexsort((dnn, rel_all[dnn]))
    jids = dnn[order]
    n_real = len(jids)
    rel = rel_all[jids]

    tasks_pos = [skel.tasks[j] for j in jids]
    task_names = sorted({t for t in tasks_pos})
    tid = {t: i for i, t in enumerate(task_names)}
    task_idx = np.array([tid[t] for t in tasks_pos], dtype=np.int64)

    ddl_off = np.array(
        [wf.deadline_offset(t) for t in task_names], dtype=np.float64
    )
    e2e = rel + ddl_off[task_idx]
    if not np.all(np.isfinite(e2e)):
        raise SoaUnsupported(
            "DNN task without a finite E2E deadline (unbounded job "
            "lifetime breaks the windowed job axis)"
        )
    sync_t = np.array(
        [model.profiles[t].sync_per_tile_s for t in task_names],
        dtype=np.float64,
    )
    ckpt_t = np.array(
        [wf.tasks[t].checkpoint_bytes for t in task_names], dtype=np.float64
    )

    # ---- segments, tables, partitions --------------------------------
    segs = _segments(scenario, duration, schedule0, portfolio, replan)
    S = len(segs)
    tables = [s[3] for s in segs]
    P = max(
        max((pp.index for pp in tbl.partitions), default=0) + 1
        for tbl in tables
    )

    # ---- round grid ---------------------------------------------------
    dt = float(opt.dt_s)
    t0s, t1s, seg_ix, entry = [], [], [], []
    for s, (a, b, _m, _tbl, _sw) in enumerate(segs):
        n = max(1, int(math.ceil((b - a) / dt - 1e-9)))
        edges = a + (b - a) * np.arange(n + 1) / n
        for k in range(n):
            t0s.append(edges[k])
            t1s.append(edges[k + 1])
            seg_ix.append(s)
            entry.append(k == 0)
    t0s = np.asarray(t0s)
    t1s = np.asarray(t1s)
    n_rounds = len(t0s)

    # ---- job windows --------------------------------------------------
    # lifetime bound: jobs normally resolve by their E2E deadline (plus
    # one dependency hop per round for the drop cascade).  Under
    # drop_mode 0 overload legally queues jobs past the E2E deadline:
    # ``life_pad_s`` widens the bound, the cap at the horizon makes a
    # wide-enough retry always possible, and run_problem's post-check
    # raises SoaWindowOverflow if the bound still proved too tight
    # (never silently truncates).
    max_hops = max((len(c.nodes) for c in wf.chains), default=4)
    cascade = (max_hops + 4) * dt
    life = (
        float(np.max(ddl_off[np.isfinite(ddl_off)]))
        + cascade
        + float(opt.life_pad_s)
    )
    life = min(max(life, 2 * dt), duration + cascade)
    lo = np.searchsorted(rel, t1s - life, side="left")
    hi = np.searchsorted(rel, t1s, side="right")
    wr = int(opt.window_round)
    W = int(max(8, ((int(np.max(hi - lo)) + wr - 1) // wr) * wr))
    lo = np.minimum(lo, np.maximum(hi - W, 0)).astype(np.int32)
    n_pad = int(max(n_real, int(np.max(lo)) + W))

    def padf(a, fill):
        out = np.full(n_pad, fill, dtype=np.float64)
        out[:n_real] = a
        return out

    rel_p = padf(rel, np.inf)
    e2e_p = padf(e2e, np.inf)
    sync_p = padf(sync_t[task_idx], 0.0)
    ckpt_p = padf(ckpt_t[task_idx], 0.0)

    # ---- finish-code columns (jobs, then sensors, then dummy) --------
    n_sen = len(sen)
    A1 = n_pad + n_sen + 1
    col_of = np.full(int(max(rel_all.shape[0], 1)), A1 - 1, dtype=np.int64)
    col_of[jids] = np.arange(n_real)
    col_of[sen] = n_pad + np.arange(n_sen)

    # predecessors from the skeleton's successor lists
    preds_l: List[List[int]] = [[] for _ in range(n_real)]
    pos_of = np.full_like(col_of, -1)
    pos_of[jids] = np.arange(n_real)
    for j, succs in enumerate(skel.succs):
        for sjid in succs:
            p = pos_of[sjid]
            if p >= 0:
                preds_l[p].append(int(col_of[j]))
    PM = max(1, max((len(p) for p in preds_l), default=1))
    preds = np.full((n_pad, PM), A1 - 1, dtype=np.int32)
    for p, lst in enumerate(preds_l):
        preds[p, : len(lst)] = lst

    # ---- per-segment schedule bindings --------------------------------
    cand_tbl = [_candidate_table(wf, tbl, policy_name) for tbl in tables]
    C = max(
        1, max(len(c) for ct in cand_tbl for c in ct.values())
    ) if policy_name in ("tp_driven", "ads_tile") else 1

    T = len(task_names)
    ert = np.full((S, n_pad), np.inf, dtype=np.float64)
    sub = np.full((S, n_pad), np.inf, dtype=np.float64)
    tgt = np.full((S, n_pad), np.inf, dtype=np.float64)
    pdop = np.ones((S, n_pad), dtype=np.float64)
    part = np.zeros((S, n_pad), dtype=np.float64)
    cands = np.ones((S, n_pad, C), dtype=np.float64)
    caps = np.zeros((S, P), dtype=np.float64)
    hops = np.ones((S, P), dtype=np.float64)
    staged = np.zeros((S, P), dtype=np.float64)
    swap = np.zeros(S, dtype=bool)

    for s, (a, b, m, tbl, sw) in enumerate(segs):
        ert_o = np.zeros(T)
        sub_o = np.zeros(T)
        dop_o = np.ones(T)
        par_o = np.zeros(T)
        dwn_o = np.zeros(T)
        cnd_o = np.ones((T, C))
        down = _downstream_budget(wf, tbl) if policy_name == "ads_tile" else {}
        for t, i in tid.items():
            plan = tbl.plans[t]
            ert_o[i] = plan.ert_s
            sub_o[i] = plan.subdeadline_s
            dop_o[i] = plan.dop
            par_o[i] = plan.partition
            dwn_o[i] = down.get(t, 0.0)
            if C > 1 or policy_name in ("tp_driven", "ads_tile"):
                ladder = cand_tbl[s][t]
                cnd_o[i, : len(ladder)] = ladder
                cnd_o[i, len(ladder):] = ladder[-1]
        ert[s, :n_real] = rel + ert_o[task_idx]
        sub[s, :n_real] = rel + sub_o[task_idx]
        if policy_name == "ads_tile" and slack_sharing:
            tgt[s, :n_real] = np.maximum(sub[s, :n_real], e2e - dwn_o[task_idx])
        else:
            tgt[s, :n_real] = sub[s, :n_real]
        pdop[s, :n_real] = dop_o[task_idx]
        part[s, :n_real] = par_o[task_idx]
        cands[s, :n_real, :] = cnd_o[task_idx]
        for pp in tbl.partitions:
            caps[s, pp.index] = pp.capacity
            hops[s, pp.index] = hw.avg_hops_to_mc(max(pp.capacity, 1))
        if sw:
            swap[s] = True
            staged[s] = _plan_deltas_staged(wf, tables[s - 1], tbl, P)

    # ---- per-round EDF permutations -----------------------------------
    perm = np.zeros((n_rounds, W), dtype=np.int32)
    iperm = np.zeros((n_rounds, W), dtype=np.int32)
    arangeW = np.arange(W)
    for r in range(n_rounds):
        if policy_name in ("cyc", "cyc_s"):
            key = ert[seg_ix[r], lo[r]: lo[r] + W]
            key2 = sub[seg_ix[r], lo[r]: lo[r] + W]
            o = np.lexsort((arangeW, key2, key))
        else:
            key = sub[seg_ix[r], lo[r]: lo[r] + W]
            o = np.lexsort((arangeW, key))
        perm[r] = o
        iperm[r][o] = arangeW

    f4 = np.float32
    const = {
        "release": rel_p.astype(f4),
        "e2e": e2e_p.astype(f4),
        "sync": sync_p.astype(f4),
        "ckpt": ckpt_p.astype(f4),
        "preds": preds,
        "ert": ert.astype(f4),
        "sub": sub.astype(f4),
        "tgt": tgt.astype(f4),
        "pdop": pdop.astype(f4),
        "part": part.astype(f4),
        "cands": cands.astype(f4),
        "caps": caps.astype(f4),
        "hops": hops.astype(f4),
        "staged": staged.astype(f4),
        "swap": swap,
        "t0": t0s.astype(f4),
        "t1": t1s.astype(f4),
        "seg": np.asarray(seg_ix, dtype=np.int32),
        "lo": lo.astype(np.int32),
        "entry": np.asarray(entry, dtype=bool),
        "perm": perm,
        "iperm": iperm,
    }

    cfg = K.KernelConfig(
        policy=K.POLICY_IDS[policy_name],
        R=int(n_lanes),
        W=W,
        C=C,
        PM=PM,
        P=P,
        tile_flops=float(hw.tile_flops),
        fixed_s=float(hw.realloc.fixed_s),
        decision_s=float(hw.realloc.decision_s),
        per_hop_s=float(hw.realloc.per_hop_s),
        inv_bw=float(1.0 / hw.realloc.migration_bw),
        realloc_gate=gate,
        admission=admission,
        quota_control=quota_control,
        drop_mode=_drop_mode(policy_name, drop_policy),
        alloc_iters=int(
            opt.alloc_iters
            if opt.alloc_iters is not None
            else (8 if policy_name == "tp_driven" else 3)
        ),
        bump_passes=int(opt.bump_passes),
    )

    # ---- report-assembly side data ------------------------------------
    considered = np.zeros(n_pad, dtype=bool)
    # strict comparisons to mirror the scalar report exactly: float64
    # release/deadline arithmetic lands on the same values in both
    # backends, so a tolerance here would only *dis*agree at boundaries
    # (e.g. 1.9 + 0.1 > 2.0 in binary64)
    considered[:n_real] = (rel <= duration) & (e2e <= duration)

    chain_ddl = {c.name: c.deadline_s for c in wf.chains}
    sinks = []
    for (cname, jid), t0 in skel.sink_src.items():
        p = int(pos_of[jid]) if jid < len(pos_of) else -1
        if p < 0:
            continue
        sinks.append(
            (cname, p, float(t0), float(chain_ddl[cname]), scenario.mode_at(t0))
        )
    sinks.sort(key=lambda x: x[2])
    expected: Dict[str, int] = {c.name: 0 for c in wf.chains}
    expected_mode: Dict[str, Dict[str, int]] = {c.name: {} for c in wf.chains}
    for cname, _p, t0, ddl, m in sinks:
        if t0 + ddl <= duration:
            expected[cname] += 1
            em = expected_mode[cname]
            em[m] = em.get(m, 0) + 1

    bounds = list(scenario.boundaries())
    ends = [t for t, _m in bounds[1:]]
    ends.append(max(duration, bounds[-1][0]))
    spans: Dict[str, float] = {}
    for (bt0, m), bt1 in zip(bounds, ends):
        spans[m] = spans.get(m, 0.0) + max(
            0.0, min(bt1, duration) - min(bt0, duration)
        )
    n_switch = sum(1 for t, _m in bounds[1:] if t <= duration + _TOL)

    reserved = sum((b - a) * tbl.peak_tiles for a, b, _m, tbl, _sw in segs)
    tiles_used = max(tbl.peak_tiles for tbl in [schedule0] + tables)

    return SoaProblem(
        cfg=cfg,
        const=const,
        jids=jids,
        n_real=n_real,
        n_pad=n_pad,
        sen_jids=sen,
        sen_release=rel_all[sen],
        sen_drop=np.array(
            [skel.drop_at_release[j] for j in sen], dtype=bool
        ),
        duration=float(duration),
        num_tiles=int(hw.num_tiles),
        considered=considered,
        e2e_host=e2e_p,
        sinks=sinks,
        chain_names=[c.name for c in wf.chains],
        expected=expected,
        expected_mode=expected_mode,
        mode_order=[m for m in scenario.modes()],
        seg_mode=[m for _a, _b, m, _t, _s in segs],
        seg_span=[(a, b) for a, b, _m, _t, _s in segs],
        spans=spans,
        n_mode_switches=n_switch,
        tiles_used=int(tiles_used),
        tiles_reserved_mean=float(reserved / duration),
        frontier_meta=dict(schedule0.meta.get("autotune") or {}),
        skeleton_key=skel.key,
        life=float(life),
        win_lo_final=int(lo.max()) if n_rounds else 0,
    )


#: the reference's Pallas routing knobs; the port has none (on a CUDA
#: tensor the kernel is the path), so they are dropped on import
_PALLAS_KNOBS = ("use_pallas", "pallas_interpret")


def problem_from_arrays(cfg, const, **fields) -> SoaProblem:
    """Build a :class:`SoaProblem` from plain fields: ``cfg`` maps the
    :class:`~repro_torch.core.sim.soa_kernels.KernelConfig` field names
    to values, ``const`` maps names to NumPy arrays, and ``fields`` are
    the remaining :class:`SoaProblem` fields (arrays, lists, dicts).

    This carries a problem across from another implementation of the
    same host side — a dict of a reference problem's fields is enough,
    nothing of its classes is needed."""
    kc = {k: v for k, v in dict(cfg).items() if k not in _PALLAS_KNOBS}
    unknown = set(kc) - {f.name for f in dataclasses.fields(K.KernelConfig)}
    if unknown:
        raise TypeError(f"unknown KernelConfig fields: {sorted(unknown)}")
    return SoaProblem(
        cfg=K.KernelConfig(**kc),
        const={k: np.asarray(v) for k, v in dict(const).items()},
        **fields,
    )


# ---------------------------------------------------------------------------
# lane data + execution
# ---------------------------------------------------------------------------
def _lanes(problem: SoaProblem, btrace) -> Dict[str, np.ndarray]:
    R = len(btrace.seeds)
    f4 = np.float32
    work = np.zeros((R, problem.n_pad), dtype=f4)
    io = np.zeros((R, problem.n_pad), dtype=f4)
    work[:, : problem.n_real] = btrace.work[:, problem.jids]
    io[:, : problem.n_real] = btrace.io[:, problem.jids]

    n_sen = len(problem.sen_jids)
    A1 = problem.n_pad + n_sen + 1
    codes0 = np.full((R, A1), np.inf, dtype=f4)
    codes0[:, A1 - 1] = 0.0
    lat = btrace.sensor_lat[:, problem.sen_jids]
    fin = problem.sen_release[None, :] + lat
    codes0[:, problem.n_pad: A1 - 1] = np.where(
        problem.sen_drop[None, :],
        -problem.sen_release[None, :] - 1.0,
        fin,
    )
    return {"work": work, "io": io, "codes0": codes0}


def run_problem(
    problem: SoaProblem, btrace, seeds: Sequence[int], device="cuda"
) -> List[SimReport]:
    """Advance all lanes through the round loop on ``device`` and
    assemble one scalar-shaped :class:`SimReport` per seed."""
    if problem.cfg.R != len(seeds):
        raise ValueError(
            f"problem built for R={problem.cfg.R}, got {len(seeds)} seeds"
        )
    with metrics.phase("soa_loop"):
        out = K.simulate(
            problem.cfg, problem.const, _lanes(problem, btrace), device=device
        )
    metrics.count("soa_rounds", int(problem.const["t0"].shape[0]))
    # jobs below the final window lower bound had their window close
    # before the horizon end; any still unresolved there froze mid-queue
    # (overload past the lifetime bound) and the lane's report would
    # silently miscount it as a miss and starve its successors
    cut = min(problem.win_lo_final, problem.n_real)
    if cut > 0:
        stuck = out["state"][:, :cut] < K.DONE
        if np.any(stuck):
            n_lanes = int(np.sum(np.any(stuck, axis=1)))
            n_jobs = int(np.max(np.sum(stuck, axis=1)))
            raise SoaWindowOverflow(
                f"up to {n_jobs} job(s) per lane slid out of the "
                f"{problem.life:.3f}s SoA job window unresolved "
                f"({n_lanes}/{problem.cfg.R} lanes affected): the cell "
                "queues jobs past the E2E-deadline lifetime bound "
                "(overload under drop_policy='soft').  Widen "
                "SoaOptions.life_pad_s (the runner's SoA path retries with a "
                "doubled window automatically) or use the scalar "
                "backend for this cell."
            )
    with metrics.phase("soa_reports"):
        return _assemble_reports(problem, out)


def _assemble_reports(problem: SoaProblem, out: Dict[str, np.ndarray]):
    R = problem.cfg.R
    dur = problem.duration
    total = problem.num_tiles * dur
    cons = problem.considered
    n_jobs = int(np.sum(cons))
    state = out["state"]
    fin = out["fin"].astype(np.float64)
    deg = out["deg"] > 0.5

    dropped = (state == K.DROP) & cons[None, :]
    late = (state == K.DONE) & cons[None, :] & (fin > problem.e2e_host[None, :] + 1e-6)
    unfinished = (state < K.DONE) & cons[None, :]
    n_dropped = dropped.sum(axis=1)
    n_miss = n_dropped + late.sum(axis=1) + unfinished.sum(axis=1)

    # per-sink vectors across lanes
    sink_pos = np.array([p for _c, p, _t, _d, _m in problem.sinks], dtype=np.int64)
    sink_t0 = np.array([t for _c, _p, t, _d, _m in problem.sinks])
    sink_ddl = np.array([d for _c, _p, _t, d, _m in problem.sinks])
    st_s = state[:, sink_pos] if len(sink_pos) else np.zeros((R, 0))
    fin_s = fin[:, sink_pos] if len(sink_pos) else np.zeros((R, 0))
    deg_s = deg[:, sink_pos] if len(sink_pos) else np.zeros((R, 0), bool)
    lat_s = fin_s - sink_t0[None, :]
    done_s = st_s == K.DONE
    drop_s = st_s == K.DROP
    viol_s = done_s & ((lat_s > sink_ddl[None, :] + 1e-9) | deg_s)

    seg_mode = problem.seg_mode
    busy_seg = out["busy"]
    rel_seg = out["realloc"]
    busy_tot = busy_seg.sum(axis=1)
    rel_tot = rel_seg.sum(axis=1)
    mode_busy: Dict[str, np.ndarray] = {}
    mode_rel: Dict[str, np.ndarray] = {}
    for s, m in enumerate(seg_mode):
        mode_busy[m] = mode_busy.get(m, 0.0) + busy_seg[:, s]
        mode_rel[m] = mode_rel.get(m, 0.0) + rel_seg[:, s]

    reports: List[SimReport] = []
    for k in range(R):
        chain_count = {c: 0 for c in problem.chain_names}
        chain_viol = {c: 0 for c in problem.chain_names}
        chain_lats: Dict[str, List[float]] = {c: [] for c in problem.chain_names}
        sink_by_mode: Dict[Tuple[str, str], List[int]] = {}
        mode_lats: Dict[str, List[float]] = {}
        for i, (cname, _p, t0, _ddl, m) in enumerate(problem.sinks):
            if done_s[k, i]:
                chain_count[cname] += 1
                chain_viol[cname] += int(viol_s[k, i])
                chain_lats[cname].append(float(lat_s[k, i]))
                rec = sink_by_mode.setdefault((cname, m), [0, 0])
                rec[0] += 1
                rec[1] += int(viol_s[k, i])
                mode_lats.setdefault(m, []).append(float(lat_s[k, i]))
            elif drop_s[k, i]:
                chain_count[cname] += 1
                chain_viol[cname] += 1
                rec = sink_by_mode.setdefault((cname, m), [0, 0])
                rec[0] += 1
                rec[1] += 1

        # starvation deficits, reconciled chronologically per mode
        for cname in problem.chain_names:
            deficit = max(0, problem.expected[cname] - chain_count[cname])
            if not deficit:
                continue
            chain_viol[cname] += deficit
            chain_count[cname] = problem.expected[cname]
            em = problem.expected_mode[cname]
            for m in problem.mode_order:
                if m not in em:
                    continue
                rec = sink_by_mode.setdefault((cname, m), [0, 0])
                take = min(max(0, em[m] - rec[0]), deficit)
                if take:
                    rec[0] += take
                    rec[1] += take
                    deficit -= take
                if not deficit:
                    break

        p99 = {
            c: (float(np.percentile(ls, 99)) if ls else float("nan"))
            for c, ls in chain_lats.items()
        }
        mode_stats: Dict[str, ModeStats] = {}
        for m, span in problem.spans.items():
            done_m = sum(
                rec[0] for (_c, mm), rec in sink_by_mode.items() if mm == m
            )
            viol_m = sum(
                rec[1] for (_c, mm), rec in sink_by_mode.items() if mm == m
            )
            lats = mode_lats.get(m, [])
            denom = problem.num_tiles * span
            mb = float(np.asarray(mode_busy.get(m, 0.0))[k]) if m in mode_busy else 0.0
            mr = float(np.asarray(mode_rel.get(m, 0.0))[k]) if m in mode_rel else 0.0
            mode_stats[m] = ModeStats(
                mode=m,
                span_s=span,
                n_completed=done_m,
                n_violations=viol_m,
                p99_s=(
                    float(np.percentile(np.asarray(lats), 99))
                    if lats else float("nan")
                ),
                effective_frac=mb / denom if denom > 0 else 0.0,
                realloc_frac=mr / denom if denom > 0 else 0.0,
            )

        busy = float(busy_tot[k])
        rel_ts = float(rel_tot[k])
        reports.append(SimReport(
            duration_s=dur,
            total_tiles=problem.num_tiles,
            effective_frac=busy / total,
            realloc_frac=rel_ts / total,
            idle_frac=max(0.0, 1.0 - (busy + rel_ts) / total),
            dropped_work_frac=float(out["dropped_work"][k]) / total,
            n_realloc=int(round(float(out["n_realloc"][k]))),
            realloc_bytes=float(out["realloc_bytes"][k]),
            n_jobs=n_jobs,
            n_dropped=int(n_dropped[k]),
            task_miss_rate=float(n_miss[k]) / max(n_jobs, 1),
            chain_count=chain_count,
            chain_violations=chain_viol,
            chain_p99_s=p99,
            chain_latencies=chain_lats,
            decision_ratios=[],
            mode_stats=mode_stats,
            n_mode_switches=problem.n_mode_switches,
            forecast=None,
            tiles_used=problem.tiles_used,
            tiles_reserved_mean=problem.tiles_reserved_mean,
            frontier_meta=dict(problem.frontier_meta),
        ))
    return reports


# ---------------------------------------------------------------------------
# distributional-equivalence machinery
# ---------------------------------------------------------------------------
def ks_statistic(a: Sequence[float], b: Sequence[float]) -> float:
    """Two-sample Kolmogorov-Smirnov statistic (sup ECDF distance)."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else 1.0
    pool = np.concatenate([a, b])
    ca = np.searchsorted(a, pool, side="right") / len(a)
    cb = np.searchsorted(b, pool, side="right") / len(b)
    return float(np.max(np.abs(ca - cb)))


def mean_ci(xs: Sequence[float], z: float = 1.96) -> Tuple[float, float]:
    """Normal-approximation confidence interval of the mean."""
    x = np.asarray(xs, dtype=np.float64)
    m = float(np.mean(x))
    if len(x) < 2:
        return m, m
    half = z * float(np.std(x, ddof=1)) / math.sqrt(len(x))
    return m - half, m + half


def intervals_overlap(
    a: Tuple[float, float], b: Tuple[float, float], pad: float = 0.0
) -> bool:
    return a[0] - pad <= b[1] and b[0] - pad <= a[1]


def structural_invariants(report: SimReport) -> Dict[str, object]:
    """The exactly-matched facts of a run: job universe, seam structure,
    chain universe and reservation footprint.  Both engines must agree
    on these bit-for-bit (they are schedule/skeleton facts, not
    sampling outcomes)."""
    return {
        "n_jobs": report.n_jobs,
        "n_mode_switches": report.n_mode_switches,
        "chains": tuple(sorted(report.chain_count)),
        "mode_spans": tuple(
            sorted((m, round(s.span_s, 9)) for m, s in report.mode_stats.items())
        ),
        "total_tiles": report.total_tiles,
        "tiles_used": report.tiles_used,
        "tiles_reserved_mean": round(report.tiles_reserved_mean, 6),
        "duration_s": report.duration_s,
    }
