"""The port's fused EDF allocator (``edf_alloc_ladder``) and ads's Phase B
start validation (``edf_start_keep``) against the JAX reference, on the CPU.

On the CPU both run their plain versions; on the card one launch each of
the fused kernel in ``csrc/ladder_grant.cu``, which ``tests/test_torch_gpu.py``
holds to these plain versions bit for bit.  Here the plain versions are
held **exactly** (``np.array_equal``) to the reference's own composition:
the EDF gathers, ``_alloc_ladder`` run through the Pallas grant in
interpret mode, ``_bump_work_conserving`` and the inverse gather.  Every
operand is an integer tile count or DoP rung in float32, so every prefix
sum is exact in any order and equality is the right test; the last test
here shows that the SoA path only ever feeds such values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sim import soa_kernels as K_ref
from repro_torch.core.sim import soa as soa_t
from repro_torch.core.sim import soa_kernels as K_t
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.scenarios import ScenarioSpec, get_scenario
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import BUNDLED_SCENARIOS

torch.set_num_threads(1)

R = 5


def _cfg(W, C, P, alloc_iters, bump_passes):
    return K_ref.KernelConfig(
        policy=K_ref.POLICY_IDS["tp_driven"], R=R, W=W, C=C, PM=1, P=P,
        tile_flops=1.0, fixed_s=0.0, decision_s=0.0, per_hop_s=0.0, inv_bw=0.0,
        alloc_iters=alloc_iters, bump_passes=bump_passes,
        use_pallas=True, pallas_interpret=True,
    )


def _inputs(W, C, P, seed, *, part_rows=R, cand_lanes=False, cap_rows=R, kind=""):
    """Integer-valued queues as the round loop builds them: ladders sorted
    and padded by repeating the last rung, wants on the ladder or 0,
    partition ids with a few out of range (the kernel clamps them as the
    reference does), a random EDF permutation."""
    rng = np.random.default_rng(seed)
    shape = (R, W, C) if cand_lanes else (W, C)
    cand = np.sort(rng.integers(1, 49, size=shape), axis=-1).astype(np.float32)
    pad = rng.integers(1, C + 1, size=shape[:-1])
    cand = np.where(np.arange(C) >= pad[..., None], np.take_along_axis(
        cand, (pad - 1)[..., None], axis=-1), cand).astype(np.float32)
    pick = rng.integers(0, C, size=(R, W))
    rows = np.broadcast_to(cand, (R, W, C))
    want = np.take_along_axis(rows, pick[..., None], axis=-1)[..., 0]
    want = np.where(rng.random((R, W)) < 0.15, 0.0, want).astype(np.float32)
    entry = rng.random((R, W)) < 0.7
    part = rng.integers(-1, P + 1, size=(part_rows, W)).astype(np.float32)
    cap = rng.integers(0, 160, size=(cap_rows, P)).astype(np.float32)
    if kind == "empty":
        entry[:] = False
    elif kind == "want_high":
        want[:] = 1000.0
    elif kind == "pool_zero":
        cap[:] = 0.0
    perm = rng.permutation(W).astype(np.int64)
    return want, entry, part, cand, cap, perm


def _reference_alloc(want, entry, part, cand, cap, perm, alloc_iters, bump_passes):
    """The reference's edf_alloc: gathers, _alloc_ladder (Pallas grant in
    interpret mode), optional _bump_work_conserving, inverse gather."""
    W, C, P = want.shape[1], cand.shape[-1], cap.shape[-1]
    cfg = _cfg(W, C, P, alloc_iters, bump_passes or 0)
    part_s = np.broadcast_to(part, (R, W))[:, perm]
    cap_r = jnp.asarray(np.broadcast_to(cap, (R, P)))
    args = [jnp.asarray(a) for a in (want[:, perm], entry[:, perm], part_s,
                                     np.take(cand, perm, axis=-2))]
    grant = K_ref._alloc_ladder(cfg, *args, cap_r)
    if bump_passes is not None:
        grant = K_ref._bump_work_conserving(cfg, grant, *args[1:], cap_r)
    return np.asarray(grant)[:, np.argsort(perm)]


def _port_alloc(want, entry, part, cand, cap, perm, alloc_iters, bump_passes):
    t = torch.from_numpy
    before = K_t.edf_alloc_ladder.launches
    got = K_t.edf_alloc_ladder(
        t(want), t(entry), t(part), t(cand), t(cap), t(perm),
        alloc_iters=alloc_iters, bump_passes=bump_passes,
    ).numpy()
    assert K_t.edf_alloc_ladder.launches == before  # plain version: no kernel
    return got


def _check_alloc(inputs, alloc_iters, bump_passes):
    want = _reference_alloc(*inputs, alloc_iters, bump_passes)
    got = _port_alloc(*inputs, alloc_iters, bump_passes)
    assert np.array_equal(want, got), np.argwhere(want != got)[:5]
    return got


@pytest.mark.parametrize("W", [8, 96, 160, 300])
@pytest.mark.parametrize("C", [1, 6])
@pytest.mark.parametrize("P", [1, 4, 21])
def test_alloc_matches_reference(P, C, W):
    # alloc_iters as the policies set it: tp_driven 8 (its P is 1), the
    # others 3; the bump (tp_driven's) also at P > 1 and at C = 1, where
    # no entry has a rung to bump to
    inputs = _inputs(W, C, P, seed=1000 * P + 10 * C + W)
    iters = 8 if P == 1 else 3
    _check_alloc(inputs, iters, None)
    _check_alloc(inputs, iters, 8)


@pytest.mark.parametrize("part_rows, cand_lanes, cap_rows", [
    (1, False, R),   # cyc / ads Phase A: one partition row for all lanes, free pool
    (R, False, 1),   # tp / ads Phase B: per-lane partitions, shared full pool
    (R, True, R),    # per-lane ladder rows
    (1, True, 1),
])
def test_alloc_argument_layouts(part_rows, cand_lanes, cap_rows):
    inputs = _inputs(96, 6, 4, seed=7, part_rows=part_rows,
                     cand_lanes=cand_lanes, cap_rows=cap_rows)
    _check_alloc(inputs, 3, None)
    _check_alloc(inputs, 3, 8)


@pytest.mark.parametrize("kind", ["empty", "want_high", "pool_zero"])
@pytest.mark.parametrize("P", [1, 4])
def test_alloc_edge_cases(kind, P):
    inputs = _inputs(160, 6, P, seed=3, kind=kind)
    got = _check_alloc(inputs, 3, 8)
    if kind in ("empty", "pool_zero"):
        assert not got.any()
    if kind == "want_high":
        assert got.any()  # the top rungs fit some budgets


def test_cpu_dispatch_and_cuda_wrapper_refusals():
    want, entry, part, cand, cap, perm = (
        torch.from_numpy(a) for a in _inputs(16, 3, 2, seed=1))
    kw = dict(alloc_iters=3, bump_passes=None)
    cuda = K_t._edf_alloc_ladder_cuda
    # every refusal comes from attributes, before the library is loaded
    with pytest.raises(TypeError):
        cuda(want.double(), entry, part, cand, cap, perm, 3, None)
    with pytest.raises(ValueError, match="perm"):
        cuda(want, entry, part, cand, cap, perm.int(), 3, None)
    with pytest.raises(ValueError, match="entry"):
        cuda(want, entry.float(), part, cand, cap, perm, 3, None)
    with pytest.raises(ValueError, match="cand_rows"):
        cuda(want, entry, part, cand[:8], cap, perm, 3, None)
    with pytest.raises(ValueError, match="part"):
        cuda(want, entry, part[:, :8], cand, cap, perm, 3, None)
    with pytest.raises(ValueError, match="contiguous"):
        cuda(want.t().contiguous().t(), entry, part, cand, cap, perm, 3, None)
    big = 6000
    with pytest.raises(ValueError, match=f"W={big}"):
        cuda(torch.zeros(2, big), torch.zeros(2, big, dtype=torch.bool),
             torch.zeros(1, big), torch.ones(big, 6), torch.ones(2, 4),
             torch.arange(big), 3, None)
    with pytest.raises(ValueError, match="perm"):
        K_t._edf_start_keep_cuda(want, part, cap, perm[:8])
    # a CPU tensor takes the plain version and launches nothing
    before = K_t.edf_alloc_ladder.launches
    out = K_t.edf_alloc_ladder(want, entry, part, cand, cap, perm, **kw)
    keep = K_t.edf_start_keep(want, part, cap, perm)
    assert out.shape == want.shape and keep.dtype == torch.bool
    assert K_t.edf_alloc_ladder.launches == before


# ---------------------------------------------------------------------------
# Phase B's start validation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [8, 96, 160, 300])
@pytest.mark.parametrize("P", [1, 4, 21])
def test_start_keep_matches_reference(P, W):
    rng = np.random.default_rng(50 * P + W)
    for part_rows, avail_rows in ((1, R), (R, 1)):
        d = np.where(rng.random((R, W)) < 0.4,
                     rng.integers(1, 49, size=(R, W)), 0).astype(np.float32)
        part = rng.integers(-1, P + 1, size=(part_rows, W)).astype(np.float32)
        avail = rng.integers(-20, 200, size=(avail_rows, P)).astype(np.float32)
        perm = rng.permutation(W).astype(np.int64)
        # the reference's Phase B, src/repro/core/sim/soa_kernels.py
        cfg = _cfg(W, 1, P, 3, 8)
        d_s = jnp.asarray(d[:, perm])
        excl, _, availg = K_ref._class_prefix(
            cfg, jnp.asarray(np.broadcast_to(part, (R, W))[:, perm]),
            jnp.asarray(np.broadcast_to(avail, (R, P))), d_s.dtype)
        keep_s = (d_s > 0) & (excl(d_s) + d_s <= availg + 0.5)
        want = np.asarray(keep_s)[:, np.argsort(perm)]
        t = torch.from_numpy
        got = K_t.edf_start_keep(t(d), t(part), t(avail), t(perm)).numpy()
        assert np.array_equal(want, got)


# ---------------------------------------------------------------------------
# the round loop's use of them
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy, per_round", [
    ("cyc", {"alloc": 1, "keep": 0}),
    ("tp_driven", {"alloc": 1, "keep": 0}),
    ("ads_tile", {"alloc": 2, "keep": 1}),
])
def test_round_loop_calls_fused_allocator_once_per_allocation(monkeypatch, policy, per_round):
    # the card launches one kernel per call: ads_tile 3 per round (Phase
    # A, Phase B, the validation), the others 1; the standalone grant
    # never runs on the loop's path
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy)
    wf, model, sched, pf = runner_t._prepare_run(spec)
    prob = soa_t.build_problem(wf, model, sched, pf, runner_t._make_run_policy(spec, pf),
                               spec.scenario, 0.05, n_lanes=2)
    calls = {"alloc": 0, "keep": 0}
    alloc, keep = K_t.edf_alloc_ladder, K_t.edf_start_keep

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("the round loop called the standalone grant")

    monkeypatch.setattr(K_t, "edf_alloc_ladder", count("alloc", alloc))
    monkeypatch.setattr(K_t, "edf_start_keep", count("keep", keep))
    monkeypatch.setattr(K_t, "ladder_grant", refuse)
    n = prob.const["t0"].shape[0]
    bt = sample_trace_batch(build_skeleton(wf, spec.scenario, 0.05), model,
                            spec.scenario, [0, 1])
    lanes = soa_t._lanes(prob, bt)
    K_t.simulate(prob.cfg, prob.const, lanes, device="cpu")
    assert calls == {k: v * n for k, v in per_round.items()}


def test_soa_problems_hold_integer_tile_counts():
    """Equality of kernel and plain version rests on integer operands: every
    ladder rung, planned DoP and partition capacity the SoA path can be fed
    is an integer, in every bundled scenario and policy.  Scenarios that
    inject degradations (thermal throttle, tile faults), the only seams
    that scale capacities, are refused by the SoA path altogether."""
    checked = 0
    for name in BUNDLED_SCENARIOS:
        scen = get_scenario(name)
        for policy in ("cyc", "cyc_s", "tp_driven", "ads_tile"):
            spec = ScenarioSpec(scenario=scen, policy=policy, cockpit_replicas=4)
            ok, _why = runner_t.soa_usable(spec)
            if getattr(scen, "has_degradations", False):
                assert not ok
                continue
            assert ok
            wf, model, sched, pf = runner_t._prepare_run(spec)
            prob = soa_t.build_problem(wf, model, sched, pf,
                                       runner_t._make_run_policy(spec, pf),
                                       scen, 0.3, n_lanes=1)
            for k in ("cands", "caps", "pdop"):
                v = np.asarray(prob.const[k])
                assert np.array_equal(v, np.round(v)) and np.all(np.abs(v) < 2 ** 20), (name, k)
            checked += 1
    assert checked >= 12
