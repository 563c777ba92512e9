"""The SoA cell's ``correct`` on the CPU at a size a test run holds: a
sound run passes, and the control and each fault the cell can have are
caught.  The harness's look for a card is skipped (``device="cpu"``);
the rest of a run is driven as on the card."""
import dataclasses

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.ref_soa.lanes import reference_lanes
from h100bench.systems import soa as S

from repro_torch.core.sim import soa as program_soa
from repro_torch.core.sim import soa_kernels as K
from repro_torch.scenarios import runner

BIG = 2 ** 31 + 77
DURATION = 0.4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs: the suite's parallel workers
    would otherwise oversubscribe the cores many times over, and these
    runs read the clock."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    cfg = harness.load_config("ads-l4-x4")
    cfg["deployment"]["lanes_per_fan"] = 6
    mix = harness.load_traffic("commute-ads_tile")
    mix.update(duration_s=DURATION, check_lanes_per_fan=6)
    return cfg, mix


def _run(trace=False):
    cfg, mix = _cell()
    return S.run_cell(cfg, mix, seed=BIG, seconds=0.01, trace=trace, device="cpu")


def test_a_sound_run_is_correct():
    res = _run()
    assert res.correct, res.checks
    assert res.attempted == 6 and res.failed == 0
    assert res.end_to_end["drive_s_per_s"] > 0 and res.end_to_end["setup_s"] > 0
    assert [c.name for c in res.checks] == list(harness.load_config("ads-l4-x4")["checks"])


def test_a_traced_run_reads_the_program_s_counters():
    res = _run(trace=True)
    assert res.correct
    t = res.trace
    assert t.extras["fans"] >= 1 and t.counters["soa_rounds"] >= DURATION / 1e-3
    assert {"soa_loop", "soa_reports", "trace_sample", "soa_build"} <= set(t.phases)
    assert {"fan", "sampler", "round loop", "reports", "problem build"} <= {n for n, *_ in t.spans}


def test_the_reference_is_the_event_driven_engine():
    """Each reference lane is the program's scalar engine's report for its
    seed, bit for bit, whichever lanes it is run beside."""
    from repro_torch.scenarios import ScenarioSpec, get_scenario, run

    alone = reference_lanes("commute", "ads_tile", 4, [11], duration_s=DURATION)
    beside = reference_lanes("commute", "ads_tile", 4, [5, 11], duration_s=DURATION)
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy="ads_tile", cockpit_replicas=4,
                        duration_s=DURATION, seed=11)
    [want] = run(spec, backend="scalar", device="cpu")
    for got in (alone["reports"][0], beside["reports"][1]):
        assert got.chain_latencies == want.chain_latencies
        assert got.realloc_frac == want.realloc_frac and got.n_jobs == want.n_jobs
    assert np.array_equal(alone["draws"]["work"][0], beside["draws"]["work"][1])


def test_compare_reads_each_number_by_hand():
    def lane(v, r, e, lat, inv=(1,)):
        return {"violation_rate": v, "realloc_frac": r, "busy": e,
                "invariants": inv, "lat": np.asarray(lat, float)}

    want = [lane(0.1, 0.2, 0.5, [1, 2]), lane(0.3, 0.2, 0.5, [3, 4])]
    got = [lane(0.1, 0.3, 0.5, [1, 2]), lane(0.1, 0.3, 0.4, [3, 9], inv=(2,))]
    draws = {f: np.ones((2, 3)) for f in S.DRAW_FIELDS}
    skew = {f: np.ones((2, 3)) for f in S.DRAW_FIELDS}
    skew["io"] = np.full((2, 3), 1.5)
    r = S.compare(got, want, skew, draws)
    assert r["draw_rel_err"] == 0.5 and r["invariants_differing"] == 1.0
    assert r["lat_ks"] == 0.25                      # 4 of want below 4 against 3 of got
    assert r["viol_rel_gap"] == pytest.approx(0.5)  # 0.1 against 0.2
    assert r["realloc_rel_gap"] == pytest.approx(0.5)
    assert r["busy_lane_gap"] == pytest.approx(0.2)   # 0.4 against 0.5 in the second lane
    short = S.compare(got[:1], want, draws, draws)
    assert all(v == float("inf") for v in short.values())


def test_the_control_fails():
    """The reference in the program's place with its draws in bfloat16."""
    cfg, mix = _cell()
    seeds = [BIG * 10 ** 6 + j for j in range(4)]
    ref = S._reference(cfg, mix, seeds)
    ctl = S._reference(cfg, mix, seeds, draws_dtype=torch.bfloat16)
    readings = S.compare([S.lane_summary(r) for r in ctl["reports"]],
                         [S.lane_summary(r) for r in ref["reports"]], ctl["draws"], ref["draws"])
    checks = harness.fan_checks(cfg["checks"], readings)
    assert not all(c.ok for c in checks), readings


def _faulty(monkeypatch, target, name, make):
    monkeypatch.setattr(target, name, make(getattr(target, name)))
    res = _run()
    assert not res.correct, res.checks
    return res


def test_a_round_loop_that_leaves_its_state_unchanged_fails(monkeypatch):
    def make(orig):
        def still(cfg, host, dc, work, io, codes):
            none = {k: v[:0] for k, v in host.items()}
            return orig(cfg, none, dc, work, io, codes)
        return still
    _faulty(monkeypatch, K, "_run_rounds", make)


@pytest.mark.parametrize("how", ["dropped", "copied"])
def test_half_the_lanes_left_out_fails(monkeypatch, how):
    """Half the lanes not run: their reports missing, or copies of the
    other half's."""
    def make(orig):
        def half(problem, btrace, seeds, device="cuda"):
            reports = orig(problem, btrace, seeds, device)
            h = len(reports) // 2
            if how == "dropped":
                return reports[:h]
            return reports[:h] + [dataclasses.replace(r) for r in reports[:len(reports) - h]]
        return half
    _faulty(monkeypatch, program_soa, "run_problem", make)


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    def make(orig):
        def altered(problem, out):
            reports = orig(problem, out)
            for r in reports:
                r.chain_latencies = {c: [x * 1.2 for x in v]
                                     for c, v in r.chain_latencies.items()}
            return reports
        return altered
    _faulty(monkeypatch, program_soa, "_assemble_reports", make)


def test_draws_altered_in_the_sampler_fail(monkeypatch):
    def make(orig):
        def skewed(*a, **kw):
            bt = orig(*a, **kw)
            return dataclasses.replace(bt, work=np.asarray(bt.work) * 1.001)
        return skewed
    res = _faulty(monkeypatch, runner, "sample_trace_batch", make)
    assert not next(c for c in res.checks if c.name == "draw_rel_err").ok


@pytest.mark.gpu
def test_the_soa_cell_on_the_card(card):
    """One short run of the SoA cell on the card: correct."""
    res = S.run_cell(harness.load_config("ads-l4-x4"), harness.load_traffic("commute-ads_tile"),
                     seed=12345, seconds=1.0, trace=False, device="cuda")
    assert res.correct, res.checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
