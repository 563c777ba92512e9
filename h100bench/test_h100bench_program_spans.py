"""The readers of the program's round-loop spans and counters: each gives
its value on a synthetic trace, and None where what it reads is
missing (as in a run of a program that has no such phase)."""
import pytest

from h100bench import harness
from h100bench.tracing import TraceData

READERS = ("round_issue_us", "lane_stage_s_per_fan", "loop_drain_s_per_fan",
           "kernels_per_round")


def _phase(total_s, n=1):
    return {"n": n, "total_s": total_s, "mean_s": total_s / n}


def _trace():
    """Two fans of 2000 rounds, three allocator calls a round; a profiled
    window of 300 launches holding 1500 kernels."""
    return TraceData(
        counters={"soa_rounds": 4000, "soa_alloc_calls": 12000, "soa_window_retries": 0},
        phases={"soa_loop": _phase(24.0, 2), "soa_issue": _phase(20.0, 2),
                "soa_stage": _phase(1.5, 4), "soa_drain": _phase(0.02, 2)},
        kernels=[("k", 1e-5 * i, 1e-5 * i + 4e-6) for i in range(1500)],
        extras={"fans": 2, "alloc_launches": 300, "alloc_bytes": 1})


def _read(name, t):
    return harness.load_reader(name)(t)


def test_each_reader_gives_its_value():
    t = _trace()
    assert _read("round_issue_us", t) == pytest.approx(5000.0)
    assert _read("lane_stage_s_per_fan", t) == pytest.approx(0.75)
    assert _read("loop_drain_s_per_fan", t) == pytest.approx(0.01)
    # 300 launches at three a round: 100 rounds in the window
    assert _read("kernels_per_round", t) == pytest.approx(15.0)


@pytest.mark.parametrize("name, drop", [
    ("round_issue_us", ("phases", "soa_issue")),
    ("round_issue_us", ("counters", "soa_rounds")),
    ("lane_stage_s_per_fan", ("phases", "soa_stage")),
    ("lane_stage_s_per_fan", ("extras", "fans")),
    ("loop_drain_s_per_fan", ("phases", "soa_drain")),
    ("loop_drain_s_per_fan", ("extras", "fans")),
    ("kernels_per_round", ("counters", "soa_alloc_calls")),
    ("kernels_per_round", ("counters", "soa_rounds")),
    ("kernels_per_round", ("extras", "alloc_launches")),
    ("kernels_per_round", ("kernels", None)),
])
def test_a_reader_gives_none_where_its_input_is_missing(name, drop):
    t = _trace()
    field, key = drop
    if key is None:
        setattr(t, field, [])
    else:
        del getattr(t, field)[key]
    assert _read(name, t) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_on_an_empty_trace(name):
    assert _read(name, TraceData()) is None


def test_the_new_metrics_are_the_cell_s_and_move_its_rate():
    bench = harness.load_benchmark()
    by_name = {m["name"]: m for m in harness.cell_metrics(bench, "soa-ads-commute", "per_layer")}
    for name in READERS:
        assert by_name[name]["moves"] == "drive_s_per_s"
        assert by_name[name]["better"] == "lower"
