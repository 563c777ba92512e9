"""The port's SoA round loop under the metrics registry: its phases and
the allocator's counter when the registry is on, nothing recorded and no
profiler range opened when it is off, the phases as ``span:<name>``
ranges while a profiler records, and the lanes' reports the same either
way."""
import warnings

import pytest
import torch

from repro_torch.obs import metrics
from repro_torch.scenarios import ScenarioScript, ScenarioSpec, run
from repro_torch.scenarios.script import ModeSegment

#: two modes, so that one round hot-swaps the schedule (the seam step)
SCRIPT = ScenarioScript(name="obs-seam", segments=(
    ModeSegment(mode="urban", duration_s=0.05), ModeSegment(mode="highway", duration_s=0.05)))
SEEDS = [3, 1 << 31]
ROUND_PHASES = ("soa_round.seam", "soa_round.resolve", "soa_round.policy", "soa_round.apply")
#: the allocator's calls a round: ads_tile's Phase A, Phase B and the
#: start validation; one EDF pass for the others
CALLS_A_ROUND = {"ads_tile": 3, "tp_driven": 1, "cyc": 1}


@pytest.fixture(autouse=True)
def registry_left_off():
    """One intra-op thread, and the registry cleared and off after each
    test (the suite's workers share processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        metrics.reset()
        metrics.enable(False)


def _fan(on, policy="ads_tile"):
    """One fan through the SoA backend on the CPU; the registry's
    snapshot of it (empty while off) and the reports."""
    metrics.enable(on)
    metrics.reset()
    spec = ScenarioSpec(scenario=SCRIPT, policy=policy, cockpit_replicas=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        reports = run(spec, seeds=SEEDS, backend="soa", fallback=False, device="cpu")
    snap = metrics.snapshot(reset_after=True)
    metrics.enable(False)
    return snap, reports


def _total(snap, name):
    return snap["phases"][name]["total_s"]


def test_the_round_loop_s_phases_and_counter_appear_when_on():
    snap, _ = _fan(True)
    ph, cnt = snap["phases"], snap["counters"]
    rounds = cnt["soa_rounds"]
    assert {"soa_loop", "soa_stage", "soa_issue", "soa_drain", *ROUND_PHASES} <= set(ph)
    assert cnt["soa_alloc_calls"] > 0
    loops = ph["soa_loop"]["n"]
    assert ph["soa_issue"]["n"] == ph["soa_drain"]["n"] == loops
    # the lanes' assembly, then their upload with the statics
    assert ph["soa_stage"]["n"] == 2 * loops
    for name in ROUND_PHASES[1:]:
        assert ph[name]["n"] == rounds
    assert ph["soa_round.seam"]["n"] == loops


def test_stage_issue_and_drain_fit_inside_the_loop():
    snap, _ = _fan(True)
    parts = sum(_total(snap, n) for n in ("soa_stage", "soa_issue", "soa_drain"))
    assert 0 < parts <= _total(snap, "soa_loop")


def test_the_round_s_phases_fit_inside_the_issue():
    snap, _ = _fan(True)
    rounds = sum(_total(snap, n) for n in ROUND_PHASES)
    assert 0 < rounds <= _total(snap, "soa_issue")


@pytest.mark.parametrize("policy", sorted(CALLS_A_ROUND))
def test_alloc_calls_a_round_are_the_policy_s(policy):
    snap, _ = _fan(True, policy)
    cnt = snap["counters"]
    assert cnt["soa_alloc_calls"] == CALLS_A_ROUND[policy] * cnt["soa_rounds"]


def _raise(*a, **kw):
    raise AssertionError("a profiler range was opened")


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        snap, reports = _fan(False)
    assert snap == {"counters": {}, "phases": {}}
    assert len(reports) == len(SEEDS)


def test_on_without_a_profiler_opens_no_range(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    snap, _ = _fan(True)
    assert "soa_issue" in snap["phases"]


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == f"span:{name}"]


def test_phases_are_profiler_ranges_nested_in_time():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        snap, _ = _fan(True)
    [loop] = _ranges(prof, "soa_loop")
    [issue] = _ranges(prof, "soa_issue")
    policy = _ranges(prof, "soa_round.policy")
    assert len(policy) == snap["counters"]["soa_rounds"]
    assert loop[0] <= issue[0] and issue[1] <= loop[1]
    assert all(issue[0] <= s and e <= issue[1] for s, e in policy)
    # the round's phases follow one another, none inside another
    steps = sorted(r for n in ROUND_PHASES for r in _ranges(prof, n))
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))


def test_the_lanes_reports_are_the_same_on_and_off():
    _, off = _fan(False)
    _, on = _fan(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, traced = _fan(True)
    assert [repr(r) for r in on] == [repr(r) for r in off] == [repr(r) for r in traced]


class _Clock:
    """A ``time`` whose clock reads 0, 1, 2, ... seconds."""

    def __init__(self):
        self.t = -1.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def test_a_phase_seq_tiles_its_stretch_with_no_gap(monkeypatch):
    monkeypatch.setattr(metrics, "time", _Clock())
    metrics.enable()
    metrics.reset()
    with metrics.phase_seq() as seq:            # enter at 0, 1, 2; closed at 3
        seq.enter("a")
        seq.enter("b")
        seq.enter("a")
    ph = metrics.snapshot()["phases"]
    assert ph["a"]["n"] == 2 and ph["a"]["total_s"] == 2.0
    assert ph["b"]["n"] == 1 and ph["b"]["total_s"] == 1.0
    metrics.enable(False)
    with metrics.phase_seq() as seq:
        assert seq is None


def test_active_seq_is_the_innermost_open_phase_seq():
    assert metrics.active_seq() is None
    metrics.enable()
    with metrics.phase_seq() as outer:
        assert metrics.active_seq() is outer
        with metrics.phase_seq() as inner:
            assert metrics.active_seq() is inner is not outer
        assert metrics.active_seq() is outer
    assert metrics.active_seq() is None
    metrics.enable(False)
    with metrics.phase_seq():
        assert metrics.active_seq() is None


def test_a_range_still_open_when_the_profiler_stops_closes_cleanly():
    metrics.enable()
    metrics.reset()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with metrics.phase("outer"):
        with metrics.phase_seq() as seq:
            seq.enter("before")
            prof.start()
            seq.enter("inside")
            with metrics.phase("closed"):
                pass
            prof.stop()
            seq.enter("after")
    names = {e.name for e in prof.events()}
    assert "span:closed" in names
    assert not {"span:outer", "span:before", "span:after"} & names
    assert {"outer", "before", "inside", "closed", "after"} <= set(metrics.snapshot()["phases"])


#: the round loop's window and reallocation counters
WINDOW_COUNTERS = ("soa_window_live", "soa_window_cols", "soa_reallocs")


@pytest.mark.parametrize("replicas, subrounds", [(4, 1), (9, 2)])
def test_window_and_subround_counters_repeat_and_stay_off_when_off(replicas, subrounds):
    """The job window's live columns, its columns, the reallocations and,
    where a step takes sub-rounds, those taken in them: the same on a
    second run of the same fan, none of them recorded while the registry
    is off."""

    def counters(on):
        metrics.enable(on)
        metrics.reset()
        spec = ScenarioSpec(scenario=SCRIPT, policy="ads_tile", cockpit_replicas=replicas)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            reports = run(spec, seeds=SEEDS, backend="soa", fallback=False, device="cpu")
        snap = metrics.snapshot(reset_after=True)
        metrics.enable(False)
        return snap["counters"], reports

    (first, reports), (second, _) = counters(True), counters(True)
    names = WINDOW_COUNTERS + (("soa_subround_reallocs",) if subrounds > 1 else ())
    assert {k: first[k] for k in names} == {k: second[k] for k in names}
    assert 0 < first["soa_window_live"] < first["soa_window_cols"]
    assert first["soa_window_cols"] % (first["soa_rounds"] * len(SEEDS)) == 0
    assert first["soa_reallocs"] == sum(r.n_realloc for r in reports)
    if subrounds > 1:
        assert 0 < first["soa_subround_reallocs"] < first["soa_reallocs"]
    else:
        assert "soa_subround_reallocs" not in first
    assert not {*names, "soa_subround_reallocs"} & set(counters(False)[0])
