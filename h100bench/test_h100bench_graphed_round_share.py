"""The reader of the round loop's graph counters: its value on a
synthetic trace, 0 where no round was replayed, and None where what it
reads is missing (as in a run of a program that has no such counter,
or of the CPU loop, which captures nothing)."""
import pytest

from h100bench import harness
from h100bench.tracing import TraceData

NAME = "graphed_round_share"


def _trace(**counters):
    """Two fans of 2000 rounds, each loop's round 0 eager."""
    c = {"soa_rounds": 4000, "soa_graph_rounds": 3998, "soa_graph_captures": 2,
         "soa_alloc_calls": 12000}
    c.update(counters)
    return TraceData(counters={k: v for k, v in c.items() if v is not None},
                     extras={"fans": 2})


def _read(t):
    return harness.load_reader(NAME)(t)


def test_the_reader_gives_the_replayed_share():
    assert _read(_trace()) == pytest.approx(0.9995)


def test_no_replayed_round_reads_zero():
    assert _read(_trace(soa_graph_rounds=0)) == 0.0


@pytest.mark.parametrize("drop", ["soa_graph_rounds", "soa_rounds"])
def test_the_reader_gives_none_where_a_counter_is_missing(drop):
    assert _read(_trace(**{drop: None})) is None


def test_the_reader_gives_none_on_an_empty_trace():
    assert _read(TraceData()) is None


def test_the_metric_is_the_cell_s_and_moves_its_rate():
    bench = harness.load_benchmark()
    by_name = {m["name"]: m for m in harness.cell_metrics(bench, "soa-ads-commute", "per_layer")}
    m = by_name[NAME]
    assert (m["moves"], m["better"], m["unit"], m["source"], m["layer"]) == (
        "drive_s_per_s", "higher", "share", "program_counter", "round loop")
