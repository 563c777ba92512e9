"""The port's colocated server (``serving/colocated.py``) against the
reference's, on the CPU under a fake clock.

Both servers get the same ``ServedModel``s: each variant is a callable
that returns a fixed output and advances the clock by its cost, and
``time.time`` / ``time.sleep`` are patched in each module to read and
advance that clock.  The scenario is ``examples/serve_colocated.py``'s:
perception -> planner chained jobs (tight end-to-end deadlines) in
partition 0 beside two cockpit models in partition 1, six bursts, with
variants ``b1`` / ``b4``; the cases vary the costs, the ERT offsets and
the partitioning, so admission, the variant quota, slack sharing, drops
and misses all show.  The two logs must be equal entry for entry.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.serving import colocated as ref_colo
from repro_torch.serving import colocated as port_colo


class FakeClock:
    def __init__(self, t0: float = 1000.0):
        self.now = t0

    def time(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s


#: name, partition, budget_s, downstream_budget_s (the example's)
MODELS = (
    ("perception", 0, 0.08, 0.05),
    ("planner", 0, 0.05, 0.0),
    ("cockpit_seg", 1, 0.10, 0.0),
    ("cockpit_depth", 1, 0.10, 0.0),
)


@dataclasses.dataclass(frozen=True)
class Case:
    #: per model: (b1 cost s, b4 cost s)
    costs: tuple = ((0.010, 0.030), (0.008, 0.020), (0.020, 0.060), (0.040, 0.120))
    ert: tuple = (0.0, 0.0, 0.0, 0.0)
    partitions: tuple = (0, 0, 1, 1)
    bursts: int = 6
    gap_s: float = 0.0


CASES = {
    "example": Case(),
    "overload": Case(costs=((0.05, 0.12), (0.04, 0.09), (0.2, 0.5), (0.3, 0.8))),
    "ert_offsets": Case(ert=(0.0, 0.01, 0.05, 0.2), gap_s=0.02),
    "one_partition": Case(partitions=(0, 0, 0, 0), costs=((0.02, 0.04), (0.01, 0.03),
                                                         (0.05, 0.1), (0.05, 0.1))),
    "spread": Case(gap_s=0.3),
}


def _run(mod, case: Case, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=clock.time, sleep=clock.sleep))
    calls = []

    def variant(name, b, cost):
        def fn(payload):
            calls.append((name, b, round(clock.now, 9)))
            clock.sleep(cost)
            return ("out", name, b)
        return fn

    models = {}
    for (name, _, budget, down), (c1, c4), ert, part in zip(MODELS, case.costs, case.ert,
                                                             case.partitions):
        models[name] = mod.ServedModel(
            name=name, variants={"b1": (variant(name, 1, c1), c1),
                                 "b4": (variant(name, 4, c4), c4)},
            partition=part, budget_s=budget, ert_offset_s=ert, downstream_budget_s=down)
    server = mod.ColocatedServer(models, num_partitions=len(set(case.partitions)))
    rng = np.random.RandomState(0)
    for i in range(case.bursts):
        toks = rng.randint(0, 100, (4, 16)).astype(np.int32)

        def chain_cb(_out, toks=toks):
            server.submit("planner", toks, deadline_s=0.15)

        server.submit("perception", toks, deadline_s=0.25, done_cb=chain_cb)
        server.submit("cockpit_seg", toks, deadline_s=1.0)
        server.submit("cockpit_depth", toks, deadline_s=1.0)
        clock.sleep(case.gap_s)
    log = server.run(duration_s=20.0)
    return log, calls, clock.now


@pytest.mark.parametrize("case", sorted(CASES))
def test_logs_equal_entry_for_entry(case, monkeypatch):
    ref_log, ref_calls, ref_end = _run(ref_colo, CASES[case], monkeypatch)
    log, calls, end = _run(port_colo, CASES[case], monkeypatch)
    assert log == ref_log
    assert calls == ref_calls
    assert end == ref_end
    # every submitted job ran or was dropped by the server's own rule: three
    # per burst, and a planner job for each perception job that ran
    ran_perception = sum(1 for r in log if r["model"] == "perception" and not r["dropped"])
    assert len(log) == 3 * CASES[case].bursts + ran_perception
    for rec in log:
        assert rec["dropped"] or rec["variant"] in ("b1", "b4")


def test_overload_drops_and_misses_and_picks_both_variants(monkeypatch):
    log, _, _ = _run(port_colo, CASES["overload"], monkeypatch)
    assert any(r["dropped"] for r in log)
    assert any(not r["dropped"] and r["missed"] for r in log)
    example, _, _ = _run(port_colo, CASES["example"], monkeypatch)
    assert {r["variant"] for r in example if not r["dropped"]} == {"b1", "b4"}


def test_ert_offsets_delay_admission(monkeypatch):
    """A job is not admitted before its ERT: with offsets the first
    cockpit_depth run starts at least 0.2 s after its submission."""
    _, calls, _ = _run(port_colo, CASES["ert_offsets"], monkeypatch)
    first_depth = min(t for name, _, t in calls if name == "cockpit_depth")
    assert first_depth >= 1000.0 + 0.2 - 1e-9


def test_the_port_is_the_reference_verbatim():
    import inspect

    assert inspect.getsource(port_colo) == inspect.getsource(ref_colo)
