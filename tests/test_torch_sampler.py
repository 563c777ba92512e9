"""The port's torch trace sampler against the reference's NumPy sampler,
and the latency model's torch.Generator draws against their analytic
distributions."""
import math

import numpy as np
import pytest
import torch

from repro.core.sim import batch as batch_ref
from repro.core.sim.trace import build_skeleton as skel_ref
from repro.scenarios import runner as runner_ref
from repro.scenarios.script import get_scenario as get_scenario_ref
from repro_torch.core import latency_model as LM_t
from repro_torch.core.sim import batch as batch_t
from repro_torch.core.sim.trace import build_skeleton as skel_t
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import get_scenario as get_scenario_t

# the loops run many tiny ops: one intra-op thread each keeps parallel
# test workers from oversubscribing the cores
torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3, 17, 2**40 + 5]


def _inputs(scenario="commute"):
    spec_a = runner_ref.ScenarioSpec(scenario=get_scenario_ref(scenario), policy="cyc")
    spec_b = runner_t.ScenarioSpec(scenario=get_scenario_t(scenario), policy="cyc")
    wf_a, model_a, _, _ = runner_ref._prepare_run(spec_a)
    wf_b, model_b, _, _ = runner_t._prepare_run(spec_b)
    dur = spec_a.scenario.duration_s
    return (
        (skel_ref(wf_a, spec_a.scenario, dur), model_a, spec_a.scenario),
        (skel_t(wf_b, spec_b.scenario, dur), model_b, spec_b.scenario),
    )


@pytest.mark.parametrize("stream", [0, 1, 2])
def test_uniforms_bit_identical(stream):
    (sk, _, _), _ = _inputs()
    ix = np.arange(sk.n)
    want = batch_ref._uniforms_batch(
        SEEDS, stream, sk.task_keys[ix], sk.regime_arr[ix], sk.cycle_arr[ix],
        sk.idx_arr[ix],
    )
    t = [batch_t._u64_tensor(a[ix], "cpu")
         for a in (sk.task_keys, sk.regime_arr, sk.cycle_arr, sk.idx_arr)]
    got = batch_t._uniforms_batch_t(SEEDS, stream, *t).numpy()
    np.testing.assert_array_equal(want, got)
    # and the port's own NumPy path is the reference's, bit for bit
    np.testing.assert_array_equal(
        want,
        batch_t._uniforms_batch(
            SEEDS, stream, sk.task_keys[ix], sk.regime_arr[ix],
            sk.cycle_arr[ix], sk.idx_arr[ix],
        ),
    )


@pytest.mark.parametrize("scenario", ["commute", "rate_churn"])
def test_torch_sampler_matches_numpy_path(scenario):
    (sa, ma, sca), (sb, mb, scb) = _inputs(scenario)
    host = batch_ref.sample_trace_batch(sa, ma, sca, SEEDS)
    dev = batch_t.sample_trace_batch(sb, mb, scb, SEEDS, device="cpu")
    host_t = batch_t.sample_trace_batch(sb, mb, scb, SEEDS)
    for field in ("work", "io", "sensor_lat"):
        a, b = getattr(host, field), getattr(dev, field)
        # integer hash bit-identical; float transforms to the last ulps
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15, err_msg=field)
        np.testing.assert_array_equal(a, getattr(host_t, field), err_msg=field)


def test_torch_ndtri_boundaries_match_numpy():
    q = np.array([0.0, 1.0, 1e-300, 2.0**-54, 0.02425, 0.5, 0.97575, 1 - 2**-53, 0.3])
    want = LM_t.ndtri(q)
    got = batch_t._ndtri_t(torch.from_numpy(q)).numpy()
    assert got[0] == -np.inf and got[1] == np.inf
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _ks_against(samples, cdf):
    x = np.sort(np.asarray(samples, dtype=np.float64))
    n = len(x)
    f = cdf(x)
    i = np.arange(1, n + 1)
    return max(np.max(i / n - f), np.max(f - (i - 1) / n))


def test_lognormal_sample_ks():
    ln = LM_t.LogNormal(mean=2.0, p99_ratio=3.3)
    gen = torch.Generator().manual_seed(0)
    s = ln.sample(gen, (20000,)).numpy()
    cdf = np.vectorize(
        lambda v: 0.5 * (1 + math.erf((math.log(v) - ln.mu) / (ln.sigma * math.sqrt(2))))
    )
    assert _ks_against(s, cdf) < 0.015
    assert abs(s.mean() - 2.0) / 2.0 < 0.03


def test_shifted_exponential_sample_ks():
    se = LM_t.ShiftedExponential(base=1e-3, rate=500.0)
    gen = torch.Generator().manual_seed(1)
    s = se.sample(gen, (20000,)).numpy()
    assert s.min() >= 1e-3
    assert _ks_against(s, lambda v: 1 - np.exp(-500.0 * (v - 1e-3))) < 0.015


def test_chain_tail_composition_within_mc_error():
    from repro.core.latency_model import chain_tail_composition as ctc_ref

    _, (_, mb, _) = _inputs()
    (_, ma, _), _ = _inputs()
    chain = [t for t in sorted(mb.profiles) if not mb.profiles[t].is_sensor][:4]
    dops = {t: 2 for t in chain}
    a = ctc_ref(ma, chain, dops, 0.99, num_samples=20000, seed=0)
    b = LM_t.chain_tail_composition(mb, chain, dops, 0.99, num_samples=20000, seed=0)
    assert a["sum_of_quantiles_s"] == b["sum_of_quantiles_s"]
    # different generators: the Monte-Carlo estimates agree within MC error
    assert abs(a["mc_quantile_s"] - b["mc_quantile_s"]) / a["mc_quantile_s"] < 0.05
    assert abs(a["mc_mean_s"] - b["mc_mean_s"]) / a["mc_mean_s"] < 0.02

