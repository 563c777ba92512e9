"""The port's LM serving path against the live JAX reference, on the
reduced granite-moe and phi4-mini configs: the reference's freshly
initialised parameters are carried across with ``params_from_reference``
and both packages run the same inputs (drawn with NumPy from a seed).
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import LM, init_params, params_from_reference  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["granite_moe_1b", "phi4_mini_3p8b"]
TOL = dict(rtol=0, atol=1e-5)   # float32 end to end; sums reduced in another order


def _both(arch, **replace):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        cfg = dataclasses.replace(cfg, **replace)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jcfg, jp, cfg, params_from_reference(cfg, tree, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return (request.param,) + _both(request.param)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def test_configs_match_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            a = dataclasses.asdict(j_get_config(arch, reduced=reduced))
            b = dataclasses.asdict(get_config(arch, reduced=reduced))
            assert a == b, arch
            assert get_config(arch, reduced=reduced).param_count() == \
                j_get_config(arch, reduced=reduced).param_count()


def test_prefill_and_decode_match_reference(pair):
    arch, jcfg, jp, cfg, p = pair
    B, S = 2, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 2))
    jm, m = JLM(jcfg), LM(cfg)
    jc, c = jm.init_cache(B, 32), m.init_cache(B, 32, "cpu")
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tl, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])}, c)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(c[key]), _np(jc[key]), **TOL)
    for i in range(2):
        pos = S + i
        step = toks[:, pos:pos + 1]
        jl, jc = jax.jit(jm.decode_step)(jp, {"tokens": jnp.asarray(step)}, jc, pos)
        tl, c = m.decode_step(p, {"tokens": torch.from_numpy(step)}, c, pos)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(c[key]), _np(jc[key]), **TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])    # the config's, and one that drops
def test_moe_routing_matches_reference_exactly(cf):
    jcfg, jp, cfg, p = _both("granite_moe_1b", moe_capacity_factor=cf)
    layer = 1
    x = np.random.default_rng(2).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    seen = {}
    real = jmoe._expert_compute

    def spy(tokens, gates, expert_ids, *rest):
        seen.update(tokens=tokens, gates=gates, ids=expert_ids)
        return real(tokens, gates, expert_ids, *rest)

    jlayer = jax.tree.map(lambda a: a[layer], jp["layers"]["moe"])
    jmoe._expert_compute = spy
    try:
        jout = jmoe.moe_apply(jlayer, jnp.asarray(x), jcfg)
    finally:
        jmoe._expert_compute = real
    # the reference's capacity/rank/keep rule (models/moe.py:58-67),
    # applied to its own expert choice
    t, k = seen["ids"].shape
    e = jcfg.num_experts
    capacity = max(8, int(jcfg.moe_capacity_factor * k * t / e))
    onehot = jax.nn.one_hot(seen["ids"].reshape(-1), e + 1, dtype=jnp.int32)
    rank = ((jnp.cumsum(onehot, axis=0) * onehot).sum(axis=1) - 1).reshape(t, k)
    jkeep = np.asarray(rank < capacity)

    tlayer = {k_: v[layer] for k_, v in p["layers"]["moe"].items()}
    tokens = torch.from_numpy(x).reshape(-1, cfg.d_model)
    gates, ids = tmoe.route(tlayer["router"], tokens, cfg.experts_per_token)
    cap, keep, _slot = tmoe.dispatch(ids, cfg.num_experts, cfg.moe_capacity_factor)
    assert cap == capacity
    np.testing.assert_array_equal(ids.numpy(), np.asarray(seen["ids"]))
    # the float32 router product sums in another order in XLA and in torch,
    # so gates agree to float32 rounding (2 ulps), and the choice exactly
    np.testing.assert_allclose(gates.numpy(), np.asarray(seen["gates"]), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert keep.all() == (cf > 1.0)     # cf=0.5 overflows a bucket: drops exercised
    out = tmoe.moe_apply(tlayer, torch.from_numpy(x), cfg)
    # unnormalised inputs give outputs up to ~50: float32 rounding is relative
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-6, atol=1e-5)


def _traffic(vocab, lens, max_new, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (n,)).astype(np.int32), max_new) for n in lens]


@pytest.mark.parametrize("lens", [
    [16] * 6,                        # the launcher's traffic: equal prompts
    [5, 12, 9, 12, 5],               # ragged prompts (ROADMAP C4 kept on purpose)
], ids=["equal", "ragged"])
def test_serving_engine_tokens_match_reference(pair, lens):
    arch, jcfg, jp, cfg, p = pair
    traffic = _traffic(cfg.vocab_size, lens, max_new=6)
    jeng = JServingEngine(jcfg, jp, JEngineConfig(max_batch=4, max_len=48))
    teng = ServingEngine(cfg, p, EngineConfig(max_batch=4, max_len=48), device="cpu")
    jreqs = [JRequest(rid=i, prompt=pr, max_new_tokens=n) for i, (pr, n) in enumerate(traffic)]
    treqs = [Request(rid=i, prompt=pr, max_new_tokens=n) for i, (pr, n) in enumerate(traffic)]
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 6 for r in treqs)
    assert teng.prefill_calls == len(lens)
    assert teng.decode_calls > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_longer_prefill(arch):
    """The port's own serving-path consistency (as test_models_smoke's):
    prefill(t[:n]) then decode(t[n]) agrees with prefill(t[:n+1]) on the
    last position.  MoE capacity is raised so no token drops."""
    cfg = get_config(arch, reduced=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    m = LM(cfg)
    p = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)))
    cache = m.init_cache(2, 32, "cpu")
    _, cache = m.prefill(p, {"tokens": toks[:, :8]}, cache)
    step, _ = m.decode_step(p, {"tokens": toks[:, 8:9]}, cache, 8)
    full, _ = m.prefill(p, {"tokens": toks}, m.init_cache(2, 32, "cpu"))
    np.testing.assert_allclose(_np(step), _np(full), rtol=1e-5, atol=1e-5)


def test_full_width_granite_params_match_reference_shapes():
    cfg = get_config("granite_moe_1b")
    mine = init_params(cfg, device="meta")
    theirs = jax.eval_shape(lambda: j_init_params(j_get_config("granite_moe_1b"),
                                                  jax.random.PRNGKey(0)))
    flat_m = {"/".join(map(str, k)): v for k, v in _flatten(mine)}
    flat_t = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    flat_t = {k.replace("['", "").replace("']", "/").rstrip("/"): v for k, v in flat_t.items()}
    assert set(flat_m) == set(flat_t)
    for k, v in flat_m.items():
        assert tuple(v.shape) == tuple(flat_t[k].shape), k
        assert str(v.dtype).replace("torch.", "") == str(flat_t[k].dtype), k
    n = sum(v.numel() for v in flat_m.values())
    assert n == sum(int(np.prod(v.shape)) for v in flat_t.values())
    assert 1.2e9 < n < 1.5e9


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_params_from_reference_refuses_a_wrong_tree():
    cfg = get_config("phi4_mini_3p8b", reduced=True)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init_params(j_get_config("phi4_mini_3p8b", reduced=True),
                                      jax.random.PRNGKey(0)))
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(cfg, {k: v for k, v in tree.items() if k != "final_norm"},
                              device="cpu")


def test_serve_launcher_runs_on_cpu(capsys):
    port_serve.main(["--arch", "granite_moe_1b", "--device", "cpu", "--requests", "3",
                     "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out
