"""The SoA round loop's steps are what a CUDA graph can replay, checked on
the CPU through the very steps the card captures.

On the card, round 0 runs the steps of ``soa_kernels._round_body``
eagerly, each step is then captured once as a CUDA graph, and every
later round replays them with the fused allocator's launches issued
eagerly between the replays.  A replay repeats the kernels of the
capture with the same arguments at the same addresses.  So here, where
the same steps run eagerly every round, each step must run the same ops
with the same Python numbers in every round, read every tensor it did
not make itself at the same address, and hand each launch operands at
the same addresses; and the per-round tables the steps read at the
device's round counter must hold, bit for bit, the numbers the loop
took from the host before it read them there.
"""
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.sim import soa
from repro_torch.core.sim import soa_kernels as K
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.obs import metrics
from repro_torch.scenarios import ScenarioSpec, get_scenario, run, runner

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3]
#: the steps of a round and the launches between them, by policy
STEPS = {"ads_tile": 5, "tp_driven": 3, "cyc": 3, "cyc_s": 3}
LAUNCHES = {"ads_tile": 3, "tp_driven": 1, "cyc": 1, "cyc_s": 1}


def _problem(policy, duration, drop_policy="soft"):
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy,
                        drop_policy=drop_policy)
    wf, model, sched, pf = runner._prepare_run(spec)
    prob = soa.build_problem(wf, model, sched, pf, runner._make_run_policy(spec, pf),
                             spec.scenario, duration, n_lanes=len(SEEDS),
                             drop_policy=drop_policy)
    bt = sample_trace_batch(build_skeleton(wf, spec.scenario, duration), model,
                            spec.scenario, SEEDS)
    return prob, soa._lanes(prob, bt)


# ---------------------------------------------------------------------------
# (a) the per-round tables
# ---------------------------------------------------------------------------
def _as_f32_operand(x: float) -> torch.Tensor:
    """A Python float as a float32 op takes it (rounded once)."""
    return torch.zeros(1) + x


def test_round_tables_hold_the_host_s_numbers_bit_for_bit():
    prob, _ = _problem("ads_tile", 2.0)
    host = {k: np.asarray(prob.const[k]) for k in K._HOST_KEYS}
    tab = K._round_tables(host, "cpu")
    n = host["t0"].shape[0]
    assert n == 2000
    assert tab["round_lo"].dtype == tab["round_seg"].dtype == torch.int64
    assert tab["round_t"].dtype == torch.float32 and tab["round_t"].shape == (n, 4)
    np.testing.assert_array_equal(tab["round_lo"].numpy(), host["lo"].astype(np.int64))
    np.testing.assert_array_equal(tab["round_seg"].numpy(), host["seg"].astype(np.int64))
    # what the loop took from the host: t0 and t1 as Python floats, and
    # the thresholds it formed from them in Python before a float32 op
    # rounded them
    want = torch.cat([
        torch.cat([_as_f32_operand(t0), _as_f32_operand(t1),
                   _as_f32_operand(t0 - 1e-9), _as_f32_operand(t1 + 1e-12)])[None]
        for t0, t1 in zip(map(float, host["t0"]), map(float, host["t1"]))
    ])
    assert torch.equal(tab["round_t"].view(torch.int32), want.view(torch.int32))
    # the thresholds are numbers of their own, not t0 and t1 again
    assert not torch.equal(tab["round_t"][:, K._T0_LO], tab["round_t"][:, K._T0])


def test_round_tables_of_no_rounds_are_empty():
    host = {"t0": np.zeros(0, np.float32), "t1": np.zeros(0, np.float32),
            "lo": np.zeros(0, np.int32), "seg": np.zeros(0, np.int32)}
    tab = K._round_tables(host, "cpu")
    assert tab["round_t"].shape == (0, 4) and tab["round_lo"].shape == (0,)


# ---------------------------------------------------------------------------
# (b) graph safety
# ---------------------------------------------------------------------------
class _OpTrace(TorchDispatchMode):
    """Every op one step runs: its name and arguments, where a Python
    number stands as itself, a tensor the step made as the op that made
    it, and any other tensor as its address, shape and strides."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rec, seen = [], set()
        for a in tree_leaves((args, kwargs or {})):
            if torch.is_tensor(a):
                p = a.untyped_storage().data_ptr()
                seen.add(p)
                if p in self.made:
                    rec.append(("made", self.made[p], tuple(a.shape)))
                else:
                    rec.append(("outside", a.data_ptr(), tuple(a.shape), a.stride()))
            else:
                rec.append(("arg", a))
        for o in tree_leaves(out):
            if torch.is_tensor(o) and o.untyped_storage().data_ptr() not in seen:
                self.made[o.untyped_storage().data_ptr()] = len(self.ops)
        self.ops.append((str(func), rec))
        return out


def _operands(args):
    return [(t.data_ptr(), tuple(t.shape), t.stride()) if torch.is_tensor(t) else t
            for t in args]


def _rounds_from(const, start, n):
    c = dict(const)
    for k in ("t0", "t1", "seg", "lo", "entry", "perm", "iperm"):
        c[k] = c[k][start:start + n]
    return c


def _traced_rounds(monkeypatch, prob, lanes, const):
    """Run the loop on the CPU through ``simulate``, every step under an
    op trace and every allocator call recorded; per round: the steps'
    traces, the launches' operands (the EDF permutation apart) and the
    permutations' addresses."""
    rounds = []
    make = K._round_body

    def body(*a):
        b = make(*a)

        def traced(step):
            def run_step():
                if not rounds or len(rounds[-1]["steps"]) == len(b.steps):
                    rounds.append({"steps": [], "launches": [], "perms": []})
                with _OpTrace() as tr:
                    step()
                rounds[-1]["steps"].append(tr.ops)
            return run_step

        b.steps = [(span, traced(step), launch) for span, step, launch in b.steps]
        return b

    def recorded(fn, at):
        def call(*args):
            rounds[-1]["launches"].append(_operands(args[:at] + args[at + 1:]))
            rounds[-1]["perms"].append(args[at].data_ptr())
            return fn(*args)
        return call

    monkeypatch.setattr(K, "_round_body", body)
    monkeypatch.setattr(K, "_edf_alloc_ladder", recorded(K._edf_alloc_ladder, 5))
    monkeypatch.setattr(K, "_edf_start_keep", recorded(K._edf_start_keep, 3))
    K.simulate(prob.cfg, const, lanes, device="cpu")
    return rounds


def _two_rounds_apart(host, moves):
    """The first of three rounds whose last two differ in ``moves``: the
    window's start, or the segment (the last a seam round)."""
    a = np.asarray(host[moves])
    return int(np.flatnonzero(a[2:] != a[1:-1])[0])


@pytest.mark.parametrize("policy, drop_policy", [
    ("ads_tile", "soft"), ("tp_driven", "soft"), ("cyc", "soft"), ("cyc_s", "soft"),
    ("ads_tile", "hard"), ("tp_driven", "hard"),
])
@pytest.mark.parametrize("moves", ["lo", "seg"])
def test_each_step_replays_one_round_in_the_next(monkeypatch, policy, drop_policy, moves):
    """Two rounds whose times differ, and whose window or segment does too:
    each step runs the same ops with the same numbers on tensors at the
    same addresses, and each launch gets operands at the same addresses
    but the round's own permutation row."""
    prob, lanes = _problem(policy, 0.8, drop_policy)
    start = _two_rounds_apart(prob.const, moves)
    const = _rounds_from(prob.const, start, 3)
    assert const["t0"][1] != const["t0"][2] and const[moves][1] != const[moves][2]
    rounds = _traced_rounds(monkeypatch, prob, lanes, const)
    assert len(rounds) == 3
    assert all(len(r["steps"]) == STEPS[policy] for r in rounds)
    assert all(len(r["launches"]) == LAUNCHES[policy] for r in rounds)
    assert sum(len(s) for s in rounds[1]["steps"]) > 100
    for i, (one, two) in enumerate(zip(rounds[1]["steps"], rounds[2]["steps"])):
        assert len(one) == len(two), f"step {i}: {len(one)} ops, then {len(two)}"
        for a, b in zip(one, two):
            assert a == b, f"step {i} differs from one round to the next: {a} / {b}"
    assert rounds[1]["launches"] == rounds[2]["launches"]
    # every launch of a round reads that round's row of the uploaded table
    for r in rounds:
        assert len(set(r["perms"])) == 1
    assert rounds[2]["perms"][0] - rounds[1]["perms"][0] == 8 * prob.cfg.W


def _handoff_ptrs(b):
    return {k: t.data_ptr() for k, t in vars(b.handoff).items() if torch.is_tensor(t)}


def test_the_handoff_keeps_its_addresses_from_round_to_round(monkeypatch):
    """Every name the steps and the launches hand on stays where round 0
    put it."""
    prob, lanes = _problem("ads_tile", 0.8)
    ptrs = []
    make = K._round_body

    def body(*a):
        b = make(*a)
        span, last, launch = b.steps[-1]

        def after():
            last()
            ptrs.append(_handoff_ptrs(b))
        b.steps[-1] = (span, after, launch)
        return b

    monkeypatch.setattr(K, "_round_body", body)
    K.simulate(prob.cfg, _rounds_from(prob.const, 0, 4), lanes, device="cpu")
    assert len(ptrs) == 4 and all(p == ptrs[0] for p in ptrs)
    assert {"win", "tt", "d_lad", "grantA", "grantB", "started2"} <= set(ptrs[0])


def test_the_handoff_copies_after_the_first_round_and_takes_a_capture_s_outputs():
    h = K._Handoff()
    a = torch.arange(4.0)
    h.put(x=a)
    first = h.x
    assert first is not a and torch.equal(first, a)
    h.put(x=a + 1)
    assert h.x is first and torch.equal(first, a + 1)
    h.capturing = True
    out = torch.zeros(4)
    h.put(x=out)
    assert h.x is out


# ---------------------------------------------------------------------------
# the CPU runs the body eagerly: no capture, no graph counter
# ---------------------------------------------------------------------------
def test_the_cpu_loop_captures_nothing():
    metrics.enable()
    metrics.reset()
    try:
        spec = ScenarioSpec(scenario=get_scenario("commute"), policy="ads_tile",
                            duration_s=0.2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run(spec, seeds=[0, 1], backend="soa", fallback=False, device="cpu")
        snap = metrics.snapshot()
    finally:
        metrics.reset()
        metrics.enable(False)
    assert snap["counters"]["soa_rounds"] > 0
    assert "soa_graph_rounds" not in snap["counters"]
    assert "soa_graph_captures" not in snap["counters"]
    assert "soa_capture" not in snap["phases"]
