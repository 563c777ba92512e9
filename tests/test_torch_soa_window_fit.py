"""The SoA job window fitted to what a cell's loops needed.

A loop that ran at a window the runner had widened reads from its final
planes the least lifetime bound whose window holds every job of every
lane to the round that resolves it (``soa._window_need``); the cell's
later fans start at that need times ``runner._SOA_FIT_MARGIN``.  Cockpit
x9 under ads_tile over the first 0.7 s of commute overflows the default
window on these seeds; its horizon window is 832 jobs wide.  The lanes
are the same work at any width that holds them, so the reports at the
need are the horizon's, and a bound just under the need overflows.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.sim import soa
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.obs import metrics
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import get_scenario

SEEDS = [0, 1, 2, 3]
DURATION = 0.7
SPEC = runner_t.ScenarioSpec(
    scenario=get_scenario("commute"), policy="ads_tile", cockpit_replicas=9,
    duration_s=DURATION,
)


@pytest.fixture(autouse=True)
def one_thread_and_the_registry_left_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        metrics.reset()
        metrics.enable(False)


@pytest.fixture
def fresh_memos(monkeypatch):
    """The runner's per-process memos, empty for this test alone."""
    monkeypatch.setattr(runner_t, "_SOA_LIFE_PAD_HINT", {})
    monkeypatch.setattr(runner_t, "_SOA_LIFE_FIT", {})


class _Cell:
    def __init__(self, spec=SPEC, seeds=SEEDS):
        self.spec, self.seeds = spec, seeds
        self.wf, self.model, self.sched, self.pf = runner_t._prepare_run(spec)
        scen = spec.scenario
        self.duration = scen.duration_s if spec.duration_s is None else spec.duration_s
        self.skel = build_skeleton(self.wf, scen, self.duration)
        self.base = soa.default_life(self.wf, self.skel)
        self.btrace = sample_trace_batch(self.skel, self.model, scen, seeds, device="cpu")

    def build(self, life, measure_need=False):
        return soa.build_problem(
            self.wf, self.model, self.sched, self.pf,
            runner_t._make_run_policy(self.spec, self.pf), self.spec.scenario,
            self.duration, n_lanes=len(self.seeds),
            options=soa.SoaOptions(life_pad_s=life - self.base), measure_need=measure_need,
        )

    def run(self, problem):
        return soa.run_problem(problem, self.btrace, self.seeds, device="cpu")


@pytest.fixture(scope="module")
def horizon():
    """The x9 lanes at the horizon's window, with the need measured; the
    loop's final planes as the need read them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    planes = {}
    orig = soa._window_need

    def keep(problem, out):
        planes.update(out)
        return orig(problem, out)

    mp = pytest.MonkeyPatch()
    mp.setattr(soa, "_window_need", keep)
    try:
        cell = _Cell()
        problem = cell.build(DURATION + 1.0, measure_need=True)
        reports = cell.run(problem)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return cell, problem, reports, planes


def _answers(report):
    """What a lane answers: its chain latencies, its rates and its
    structural facts."""
    return ({c: list(v) for c, v in sorted(report.chain_latencies.items())},
            report.violation_rate, report.realloc_frac, report.effective_frac,
            soa.structural_invariants(report))


def _assert_same_answers(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _answers(a) == _answers(b)


def test_the_need_holds_the_lanes_and_gives_the_horizons_reports(horizon):
    cell, problem, want, _ = horizon
    need = problem.need.life
    assert cell.base < need < problem.life
    at_need = cell.build(need + 1e-9)
    assert at_need.cfg.W < problem.cfg.W
    _assert_same_answers(cell.run(at_need), want)


def test_the_need_is_at_most_the_longest_stay(horizon):
    """Each job's stay, from its release to the end of the round that
    resolved it, is a lifetime whose window holds the lanes; the need is
    the least such lifetime, so at most the longest stay."""
    cell, problem, _, planes = horizon
    r = soa._resolve_rounds(problem, planes)
    rel, t1 = problem.need.release, problem.need.t1
    released = np.arange(problem.n_real)[None, :] < np.searchsorted(rel, t1, side="right")[r]
    stay = float(np.max(np.where(released, t1[r] - rel[None, :], 0.0)))
    assert problem.need.life <= stay
    assert cell.build(stay).cfg.W >= cell.build(problem.need.life + 1e-9).cfg.W


def test_a_lifetime_just_under_the_need_overflows(horizon):
    cell, problem, _, _ = horizon
    under = cell.build(problem.need.life - 1e-9)
    assert under.cfg.W < cell.build(problem.need.life + 1e-9).cfg.W
    with pytest.raises(soa.SoaWindowOverflow):
        cell.run(under)


def _spy_builds(monkeypatch):
    """Every build_problem call of the runner: its options, whether it
    asked for the need, and the problem's lifetime and width."""
    seen = []
    orig = soa.build_problem

    def spy(*a, **kw):
        problem = orig(*a, **kw)
        seen.append((kw.get("options"), kw.get("measure_need"), problem.life, problem.cfg.W))
        return problem

    monkeypatch.setattr(soa, "build_problem", spy)
    return seen


def _fan(seeds=SEEDS, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return runner_t.run(SPEC, seeds=seeds, backend="soa", fallback=False,
                            device="cpu", **kw)


def _key():
    cell = _Cell(seeds=SEEDS[:1])
    return (cell.skel.key, SPEC.policy, SPEC.drop_policy, float(DURATION))


def test_after_a_widened_window_the_next_fan_starts_at_the_fit(
        horizon, fresh_memos, monkeypatch):
    cell, problem, want, _ = horizon
    seen = _spy_builds(monkeypatch)
    metrics.enable()
    metrics.reset()
    # the first fan: the default window overflows, the doubled one holds
    _fan()
    assert [round(life, 9) for _o, _m, life, _w in seen] == [
        round(cell.base, 9), round(2 * cell.base, 9)]
    assert [m for _o, m, _l, _w in seen] == [False, True]
    fit = runner_t._SOA_LIFE_FIT[_key()]
    assert fit == problem.need.life * runner_t._SOA_FIT_MARGIN
    assert runner_t._SOA_LIFE_PAD_HINT[_key()] == pytest.approx(cell.base)
    assert metrics.snapshot()["counters"].get("soa_window_fit_hits") is None
    # the next fan starts at the fit and holds
    seen.clear()
    metrics.reset()
    _assert_same_answers(_fan(), want)
    [(_o, measured, life, width)] = seen
    assert measured and life == pytest.approx(max(cell.base, fit), abs=1e-12)
    assert width == cell.build(max(cell.base, fit)).cfg.W
    counters = metrics.snapshot()["counters"]
    assert counters["soa_window_fit_hits"] == 1
    assert counters.get("soa_window_retries", 0) == 0
    # a fan given its own options runs at them, and leaves the fit alone
    seen.clear()
    own = soa.SoaOptions(life_pad_s=cell.base)
    _fan(options=own)
    [(opts, measured, life, _w)] = seen
    assert opts is own and not measured
    assert life == pytest.approx(2 * cell.base)
    assert runner_t._SOA_LIFE_FIT[_key()] == fit


def test_a_fan_that_outlives_its_fit_retries_and_ends_with_the_horizons_reports(
        horizon, fresh_memos, monkeypatch):
    """The fit set under what these lanes need: the fan's first loop
    overflows inside the runner, the fan retries at twice the fit, ends
    with the horizon's reports, and raises the fit to its need."""
    cell, problem, want, _ = horizon
    runner_t._SOA_LIFE_PAD_HINT[_key()] = DURATION
    runner_t._SOA_LIFE_FIT[_key()] = 0.9 * problem.need.life
    seen = _spy_builds(monkeypatch)
    metrics.enable()
    metrics.reset()
    raised = []
    orig = soa.run_problem

    def watch(problem, btrace, seeds, device="cuda"):
        try:
            return orig(problem, btrace, seeds, device)
        except soa.SoaWindowOverflow as e:
            raised.append(e)
            raise

    monkeypatch.setattr(soa, "run_problem", watch)
    with pytest.warns(RuntimeWarning, match="SoA job window"):
        got = runner_t.run(SPEC, seeds=SEEDS, backend="soa", fallback=False, device="cpu")
    _assert_same_answers(got, want)
    assert len(raised) == 1
    lives = [life for _o, _m, life, _w in seen]
    assert lives == pytest.approx([0.9 * problem.need.life, 1.8 * problem.need.life])
    counters = metrics.snapshot()["counters"]
    assert counters["soa_window_retries"] == 1 and counters["soa_window_fit_hits"] == 0
    assert runner_t._SOA_LIFE_FIT[_key()] == problem.need.life * runner_t._SOA_FIT_MARGIN


def test_a_fan_whose_default_window_holds_builds_the_parents_problem(
        fresh_memos, monkeypatch):
    """soa-ads-commute's spec (cockpit x4, ads_tile, soft drops, the whole
    2.0 s drive) on two lanes whose default window holds: the fan reaches
    build_problem with the options it always had, measures nothing, and
    leaves the fit memo empty and the pad hint as it was.  (A fan of the
    cell's 1024 warm-up lanes overflows the default window, W 96, and
    holds at the doubled one, W 160, which is where the fit engages.)"""
    spec = runner_t.ScenarioSpec(scenario=get_scenario("commute"), policy="ads_tile",
                                 cockpit_replicas=4, drop_policy="soft")
    other = ("another cell",)
    runner_t._SOA_LIFE_PAD_HINT[other] = 0.25
    seen = _spy_builds(monkeypatch)
    metrics.enable()
    metrics.reset()
    got = runner_t.run(spec, seeds=SEEDS[:2], backend="soa", fallback=False, device="cpu")
    assert len(got) == 2
    [(opts, measured, _l, _w)] = seen
    assert opts == soa.SoaOptions(life_pad_s=0.0) and not measured
    assert runner_t._SOA_LIFE_FIT == {}
    assert runner_t._SOA_LIFE_PAD_HINT == {other: 0.25}
    counters = metrics.snapshot()["counters"]
    assert "soa_window_fit_hits" not in counters and "soa_window_retries" not in counters
    cell = _Cell(spec=spec, seeds=SEEDS[:2])
    plain = soa.build_problem(
        cell.wf, cell.model, cell.sched, cell.pf,
        runner_t._make_run_policy(spec, cell.pf), spec.scenario, cell.duration, n_lanes=2)
    asked = cell.build(cell.base, measure_need=True)
    assert plain.need is None and asked.need is not None
    for k in plain.const:
        np.testing.assert_array_equal(plain.const[k], asked.const[k], err_msg=k)
    assert (asked.life, asked.cfg) == (plain.life, plain.cfg)
