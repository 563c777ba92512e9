"""The six archs ported last against the live JAX reference: gemma2-27b,
gemma3-4b, stablelm-12b, deepseek-v2 (MLA, shared experts, a leading
dense layer), phi-3-vision (patch embeddings) and musicgen (codebooks).

Each runs at its ``reduced()`` config on the reference's own weights,
carried across with ``params_from_reference``; inputs are drawn with NumPy
from a seed and handed to both packages.  Float32 end to end, so the two
sides differ only by sums reduced in another order.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.models.mla as jmla  # noqa: E402
import repro.models.moe as jmoe  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import LM, init_params, params_from_reference  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)

NEW_ARCHS = ["gemma2_27b", "gemma3_4b", "stablelm_12b", "deepseek_v2_236b",
             "phi3_vision_4p2b", "musicgen_large"]
TOL = dict(rtol=0, atol=1e-5)    # as tests/test_torch_lm.py
TOL_GRAD = dict(rtol=1e-4, atol=1e-5)   # as tests/test_torch_train.py
#: prompt of 20 tokens: past gemma3's reduced window of 8 and gemma2's 16
B, S, STEPS, MAX_LEN = 2, 20, 4, 48


def _both(arch, **replace):
    jcfg = jconfigs.get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        cfg = dataclasses.replace(cfg, **replace)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jcfg, jp, cfg, params_from_reference(cfg, tree, device="cpu")


@pytest.fixture(scope="module", params=NEW_ARCHS)
def pair(request):
    return (request.param,) + _both(request.param)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(configs.ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    mine, theirs = get_config(arch, reduced=reduced), jconfigs.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()


def test_shapes_and_cells_match_reference():
    assert configs.PORTED == configs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    cells = [c for a in configs.ARCHS for c in configs.runnable_cells(get_config(a))]
    assert cells == [c for a in jconfigs.ARCHS
                     for c in jconfigs.runnable_cells(jconfigs.get_config(a))]
    assert len(cells) == 32
    assert set(configs.all_configs()) == set(configs.ARCHS)
    assert configs.get_config("deepseek-v2-236b").name == "deepseek-v2-236b"


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_params_match_reference_shapes(arch):
    """The port's tree at full width has the reference's leaves, shapes and
    dtypes (``meta`` tensors and ``jax.eval_shape``: nothing is drawn).
    C15: an untied config's ``param_count`` counts an output head of V x d
    that neither tree holds (it leaves out only the norms' few weights
    besides)."""
    cfg = get_config(arch)
    mine = dict(_flat(init_params(cfg, device="meta")))
    theirs = dict(_flat(jax.eval_shape(
        lambda: j_init_params(jconfigs.get_config(arch), jax.random.PRNGKey(0)))))
    assert set(mine) == set(theirs)
    for k, v in mine.items():
        assert tuple(v.shape) == tuple(theirs[k].shape), k
        assert str(v.dtype).replace("torch.", "") == str(theirs[k].dtype), k
    n = sum(v.numel() for v in mine.values())
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    assert abs(cfg.param_count() - head - n) < 1e-4 * n


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _prompt(cfg, rng):
    if cfg.num_codebooks:
        return rng.integers(0, cfg.vocab_size, (B, cfg.num_codebooks, S))
    return rng.integers(0, cfg.vocab_size, (B, S))


def test_prefill_and_decode_match_reference(pair):
    """A prefill and 4 greedy decode steps: logits and every cache leaf
    within ``TOL``, the greedy tokens identical (per codebook for
    musicgen); phi-3-vision's prefill takes patch embeddings first."""
    arch, jcfg, jp, cfg, p = pair
    rng = np.random.default_rng(11)
    toks = _prompt(cfg, rng)
    jbatch, batch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.num_patches:
        pe = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        jbatch["patch_embeds"], batch["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    jm, m = JLM(jcfg), LM(cfg)
    jc, c = jm.init_cache(B, MAX_LEN), m.init_cache(B, MAX_LEN, "cpu")
    assert sorted(jc) == sorted(c)
    jl, jc = jax.jit(jm.prefill)(jp, jbatch, jc)
    tl, c = m.prefill(p, batch, c)
    pos = S + cfg.num_patches
    for step in range(STEPS + 1):
        assert tuple(tl.shape) == tuple(jl.shape)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL, err_msg=f"{arch} step {step}")
        for key in jc:
            np.testing.assert_allclose(_np(c[key]), _np(jc[key]), **TOL,
                                       err_msg=f"{arch} step {step} cache {key}")
        greedy = torch.argmax(tl, dim=-1).numpy()
        np.testing.assert_array_equal(greedy, np.asarray(jnp.argmax(jl, axis=-1)))
        if step == STEPS:
            break
        nxt = greedy[..., None]                 # (B, 1) or (B, K, 1)
        jl, jc = jax.jit(jm.decode_step)(jp, {"tokens": jnp.asarray(nxt)}, jc, pos)
        tl, c = m.decode_step(p, {"tokens": torch.from_numpy(nxt)}, c, pos)
        pos += 1


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_matches_longer_prefill(arch):
    """The port's own serving-path consistency: prefill(t[:n]) then
    decode(t[n]) agrees with prefill(t[:n+1]) on the last position.  MoE
    capacity is raised so no token drops."""
    cfg = get_config(arch, reduced=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    m = LM(cfg)
    p = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    shape = (2, cfg.num_codebooks, 13) if cfg.num_codebooks else (2, 13)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, shape))
    cache = m.init_cache(2, 32, "cpu")
    _, cache = m.prefill(p, {"tokens": toks[..., :12]}, cache)
    step, _ = m.decode_step(p, {"tokens": toks[..., 12:13]}, cache, 12)
    full, _ = m.prefill(p, {"tokens": toks}, m.init_cache(2, 32, "cpu"))
    np.testing.assert_allclose(_np(step), _np(full), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# deepseek-v2: MLA and routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos", [0, 9, 30])
def test_mla_absorbed_decode_matches_reference(pos):
    """One MLA layer: a prefill of ``pos + 1`` tokens into a 40-slot cache
    (the rebuilt keys through ``ops.flash_attention``), then one absorbed
    decode step at ``pos + 1``: outputs and the latent cache within
    ``TOL``."""
    jcfg, jp, cfg, p = _both("deepseek_v2_236b")
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in p["layers"]["attn"].items()}
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, pos + 2, cfg.d_model)).astype(np.float32)
    jcache = jmla.init_mla_cache(jcfg, 2, 40, 1)
    jcc = (jcache["c_kv"][0], jcache["k_rope"][0])
    tcache = tmla.init_mla_cache(cfg, 2, 40, 1)
    tcc = (tcache["c_kv"][0], tcache["k_rope"][0])
    n = pos + 1
    jout, jcc = jmla.mla_apply(jl, jnp.asarray(x[:, :n]), jcfg, positions=jnp.arange(n),
                               cache=jcc, cache_pos=0)
    tout, tcc = tmla.mla_apply(tl, torch.from_numpy(x[:, :n]), cfg,
                               positions=torch.arange(n), cache=tcc, cache_pos=0)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    jout, jcc = jmla.mla_apply(jl, jnp.asarray(x[:, n:]), jcfg, positions=jnp.asarray([n]),
                               cache=jcc, cache_pos=n)
    tout, tcc = tmla.mla_apply(tl, torch.from_numpy(x[:, n:]), cfg,
                               positions=torch.tensor([n]), cache=tcc, cache_pos=n)
    assert tout.shape == (2, 1, cfg.d_model)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    for a, b in zip(tcc, jcc):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])    # the config's, and one that drops
def test_deepseek_routing_matches_reference_exactly(cf):
    """A deepseek MoE layer (shared expert included): the same expert
    choice, capacity and keep mask as the reference's, and the output
    within float32 rounding."""
    jcfg, jp, cfg, p = _both("deepseek_v2_236b", moe_capacity_factor=cf)
    layer = 1
    x = np.random.default_rng(2).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    seen = {}
    real = jmoe._expert_compute

    def spy(tokens, gates, expert_ids, *rest):
        seen.update(gates=gates, ids=expert_ids)
        return real(tokens, gates, expert_ids, *rest)

    jlayer = jax.tree.map(lambda a: a[layer], jp["layers"]["moe"])
    assert "shared" in jlayer
    jmoe._expert_compute = spy
    try:
        jout = jmoe.moe_apply(jlayer, jnp.asarray(x), jcfg)
    finally:
        jmoe._expert_compute = real
    t, k = seen["ids"].shape
    e = jcfg.num_experts
    capacity = max(8, int(jcfg.moe_capacity_factor * k * t / e))
    onehot = jax.nn.one_hot(seen["ids"].reshape(-1), e + 1, dtype=jnp.int32)
    rank = ((jnp.cumsum(onehot, axis=0) * onehot).sum(axis=1) - 1).reshape(t, k)

    tlayer = jax.tree.map(lambda a: a[layer], p["layers"]["moe"])
    tokens = torch.from_numpy(x).reshape(-1, cfg.d_model)
    gates, ids = tmoe.route(tlayer["router"], tokens, cfg.experts_per_token)
    cap, keep, _slot = tmoe.dispatch(ids, cfg.num_experts, cfg.moe_capacity_factor)
    assert cap == capacity
    np.testing.assert_array_equal(ids.numpy(), np.asarray(seen["ids"]))
    np.testing.assert_allclose(gates.numpy(), np.asarray(seen["gates"]), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rank < capacity))
    assert keep.all() == (cf > 1.0)
    out = tmoe.moe_apply(tlayer, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# the frontends' loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["phi3_vision_4p2b", "musicgen_large"])
def test_frontend_loss_and_grads_match_reference(arch):
    """``LM.loss`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's: musicgen averages its K
    codebook losses, phi-3-vision's patch positions carry no loss (labels
    -1 in front), and some labels are -1 on purpose."""
    jcfg, jp, cfg, p = _both(arch)
    rng = np.random.default_rng(3)
    toks = _prompt(cfg, rng)[..., :12]
    labels = rng.integers(0, cfg.vocab_size, toks.shape)
    labels[..., -2:] = -1
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.num_patches:
        pe = rng.standard_normal((toks.shape[0], cfg.num_patches, cfg.d_model)).astype(np.float32)
        batch["patch_embeds"] = torch.from_numpy(pe)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(JLM(jcfg).loss)(jp, jbatch)
    for _, leaf in _flat(p):
        leaf.requires_grad_(True)
    tl = LM(cfg).loss(p, batch)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    grads = dict(_flat(jg))
    for name, leaf in _flat(p):
        assert leaf.grad is not None, name
        np.testing.assert_allclose(_np(leaf.grad), _np(grads[name]), **TOL_GRAD, err_msg=name)


# ---------------------------------------------------------------------------
# moe_gmm at deepseek's width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,f", [(2, 8, 48), (3, 5, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_at_d5120_matches_pallas_and_oracle(e, c, f, dtype):
    """D = 5120 (deepseek-v2's d_model) at small E and F: the plain version
    against the float64 oracle and the reference's Pallas kernel in
    interpret mode (tests/test_kernels.py's tolerances)."""
    d = 5120
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(e * 100 + c + f)
    arrs = [rng.standard_normal(s).astype(np.float32) * sc
            for s, sc in (((e, c, d), 1.0), ((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
                          ((e, f, d), f ** -0.5))]
    tx, tg, tu, tdn = (torch.from_numpy(a).to(td) for a in arrs)
    jx, jg, ju, jdn = (jnp.asarray(a).astype(jd) for a in arrs)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    got = MG.moe_gmm(tx, tg, tu, tdn)
    assert got.dtype == td and got.shape == (e, c, d)
    np.testing.assert_allclose(_np(got), _np(MG.moe_gmm_oracle64(tx, tg, tu, tdn)), **tol)
    pallas = jops.moe_gmm(jx, jg, ju, jdn, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(jref.moe_gmm_ref(jx, jg, ju, jdn)), **tol)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_engine_cannot_serve_codebooks_on_either_side():
    """ROADMAP C14: the reference's engine feeds (1, S) prompts and (B, 1)
    decode tokens, which musicgen's codebook embedding cannot take: its
    first prefill fails.  The port's engine stays the reference's and
    fails there too, naming the shape it wants."""
    jcfg, jp, cfg, p = _both("musicgen_large")
    prompt = np.arange(8, dtype=np.int32)
    jeng = JServingEngine(jcfg, jp, JEngineConfig(max_batch=2, max_len=32))
    jeng.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=3))
    with pytest.raises(ValueError, match="not enough values to unpack"):
        jeng.run_until_drained()
    teng = ServingEngine(cfg, p, EngineConfig(max_batch=2, max_len=32), device="cpu")
    teng.submit(Request(rid=0, prompt=prompt, max_new_tokens=3))
    with pytest.raises(ValueError, match=r"\(B, 2, S\) codebook tokens"):
        teng.run_until_drained()
    with pytest.raises(ValueError, match="codebook tokens"):
        port_serve.main(["--arch", "musicgen_large", "--device", "cpu", "--requests", "1"])


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if a != "musicgen_large"])
def test_serving_engine_tokens_match_reference(arch):
    """The engine (phi-3-vision text-only, as the reference serves it) on
    the launcher's kind of traffic: greedy tokens identical."""
    jcfg, jp, cfg, p = _both(arch)
    rng = np.random.RandomState(0)
    traffic = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (12, 12, 7, 12, 5)]
    jeng = JServingEngine(jcfg, jp, JEngineConfig(max_batch=4, max_len=40))
    teng = ServingEngine(cfg, p, EngineConfig(max_batch=4, max_len=40), device="cpu")
    jreqs = [JRequest(rid=i, prompt=pr, max_new_tokens=5) for i, pr in enumerate(traffic)]
    treqs = [Request(rid=i, prompt=pr, max_new_tokens=5) for i, pr in enumerate(traffic)]
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 5 for r in treqs)


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if a != "musicgen_large"])
def test_serve_launcher_runs_on_cpu(arch, capsys):
    port_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out and arch in out
