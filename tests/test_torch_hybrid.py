"""The port's recurrentgemma path against the live JAX reference: the
RG-LRU kernel's plain version against the Pallas kernel (interpret mode)
and the oracle, ring-cache attention (``kv_positions``) against the
reference's ``chunked_attention``, and the reduced recurrentgemma config
(window 8, so prompts and decodes roll and wrap the ring) end to end on the
reference's own weights (``params_from_reference``).

Inputs are drawn with NumPy from a seed and handed to both packages
(bf16 inputs are rounded to nearest-even by both).
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.common import chunked_attention as j_chunked  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import LM, init_params, params_from_reference  # noqa: E402
from repro_torch.models.common import chunked_attention  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)

ARCH = "recurrentgemma_9b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    """tests/test_kernels.py's ``_tol`` (the RG-LRU sweep's tolerances)."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


#: float32 end to end on the reduced config; sums reduced in another order,
#: and the reference's LRU prefill is an associative scan, the port's a loop
MODEL_TOL = dict(rtol=0, atol=1e-4)


def _pair(x, dtype="float32"):
    x = np.asarray(x, np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# the RG-LRU kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,l,w,wb", [
    (1, 64, 64, 32),        # tests/test_kernels.py's sweep shapes
    (2, 48, 128, 128),
    (4, 1, 128, 128),       # a decode step
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rglru_matches_pallas_and_oracle(b, l, w, wb, dtype):
    rng = np.random.default_rng(b * l + w)
    (jx, tx), (jr, tr), (ji, ti) = (_pair(rng.standard_normal((b, l, w)), dtype)
                                    for _ in range(3))
    jlam, tlam = _pair(rng.standard_normal(w))
    jh0, th0 = _pair(rng.standard_normal((b, w)), dtype)
    hs, hT = RG.rglru_scan(tx, tr, ti, tlam, th0)
    assert hs.dtype == torch.float32 and hT.dtype == torch.float32
    pallas = jops.rglru_scan(jx, jr, ji, jlam, jh0, width_block=wb, interpret=True)
    oracle = jref.rglru_scan_ref(jx, jr, ji, jlam, jh0)
    mine = ref.rglru_scan_ref(tx, tr, ti, tlam, th0)
    for got, p_, o, m in zip((hs, hT), pallas, oracle, mine):
        np.testing.assert_allclose(_np(got), _np(p_), **_tol(dtype))
        np.testing.assert_allclose(_np(got), _np(o), **_tol(dtype))
        np.testing.assert_allclose(_np(m), _np(o), **_tol("float32"))


def test_rglru_dispatch_takes_the_plain_version_on_cpu_only():
    x = torch.randn(2, 5, 8)
    args = (x, torch.randn(2, 5, 8), torch.randn(2, 5, 8), torch.randn(8), torch.randn(2, 8))
    n0 = RG.rglru_scan.launches
    for a, b in zip(ops.rglru_scan(*args), RG.rglru_scan_plain(*args)):
        assert torch.equal(a, b)
    assert RG.rglru_scan.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rglru_scan(x.to("meta"), *args[1:])


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args, err", [
    ((_z(1, 4, 8, dtype=torch.float16), _z(1, 4, 8, dtype=torch.float16),
      _z(1, 4, 8, dtype=torch.float16), _z(8), _z(1, 8)), TypeError),
    ((_z(1, 4, 8), _z(1, 4, 8, dtype=torch.bfloat16), _z(1, 4, 8), _z(8), _z(1, 8)),
     TypeError),
    ((_z(1, 4, 8), _z(1, 4, 8), _z(1, 4, 8), _z(8, dtype=torch.int32), _z(1, 8)), TypeError),
    ((_z(1, 4, 8), _z(1, 4, 8), _z(1, 4, 8), _z(9), _z(1, 8)), ValueError),
    ((_z(1, 4, 8), _z(1, 4, 8), _z(1, 4, 8), _z(8), _z(2, 8)), ValueError),
    ((_z(4, 8), _z(4, 8), _z(4, 8), _z(8), _z(1, 8)), ValueError),
    ((_z(1, 0, 8), _z(1, 0, 8), _z(1, 0, 8), _z(8), _z(1, 8)), ValueError),
])
def test_rglru_cuda_wrapper_validates_before_launch(args, err):
    with pytest.raises(err):
        RG._rglru_scan_cuda(*args)


# ---------------------------------------------------------------------------
# ring-cache attention
# ---------------------------------------------------------------------------
def _ring_positions(pos, cache_len):
    idx = np.arange(cache_len)
    return pos - np.mod(pos - idx, cache_len)


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Lq, W slots, D, pos, window, softcap, block)
    (2, 4, 1, 1, 16, 16, 5, 0, 0.0, 1024),      # ring not yet full: negative slots
    (2, 4, 1, 1, 16, 16, 37, 0, 0.0, 1024),     # wrapped twice
    (1, 8, 2, 1, 8, 32, 19, 8, 0.0, 1024),      # wrapped, window = ring size
    (2, 4, 1, 1, 12, 16, 30, 6, 20.0, 5),       # window inside the ring, softcap, blocks
    (1, 4, 1, 3, 16, 256, 40, 0, 0.0, 1024),    # three queries, head dim 256
])
def test_chunked_attention_with_ring_positions_matches_reference(case):
    B, Hq, Hkv, Lq, W, D, pos, w, cap, block = case
    rng = np.random.default_rng(sum(case[:7]))
    jq, tq = _pair(rng.standard_normal((B, Hq, Lq, D)))
    jk, tk = _pair(rng.standard_normal((B, Hkv, W, D)))
    jv, tv = _pair(rng.standard_normal((B, Hkv, W, D)))
    kpos = _ring_positions(pos, W)
    assert (kpos < 0).any() == (pos < W - 1)
    kw = dict(causal=True, window=w, softcap=cap, q_offset=pos - Lq + 1, block=block)
    want = j_chunked(jq, jk, jv, kv_positions=jnp.asarray(kpos, jnp.int32), **kw)
    got = chunked_attention(tq, tk, tv, kv_positions=torch.from_numpy(kpos).int(), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    if block == 1024:
        kw.pop("block")
        got2 = FA.flash_attention(tq, tk, tv, kv_positions=torch.from_numpy(kpos).int(), **kw)
        assert torch.equal(got2, got)


@pytest.mark.parametrize("kvp", [
    torch.zeros(5, dtype=torch.int32),              # wrong length
    torch.zeros(4, dtype=torch.float32),            # not integers
    torch.zeros(2, 2, dtype=torch.int32),           # not 1-D
])
def test_flash_cuda_wrapper_validates_ring_positions(kvp):
    q, k = torch.zeros(1, 2, 1, 8), torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="kv_positions"):
        FA._flash_attention_cuda(q, k, k, causal=True, window=0, softcap=0.0, scale=None,
                                 q_offset=0, kv_offset=0, kv_valid_len=None, kv_positions=kvp)


# ---------------------------------------------------------------------------
# the model on the reduced config, on the reference's own weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jcfg, jp, cfg, params_from_reference(cfg, tree, device="cpu")


def test_config_matches_reference():
    for reduced in (False, True):
        a, b = get_config(ARCH, reduced=reduced), j_get_config(ARCH, reduced=reduced)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()


CACHE_KEYS = ("h", "conv", "k", "v")


@pytest.mark.parametrize("S, steps", [(5, 6), (12, 3)],
                         ids=["short_prompt_then_wrap", "rolled_prompt"])
def test_prefill_and_decode_match_reference(pair, S, steps):
    """Window 8, max_len 32: an 8-slot ring.  A 5-token prompt writes slots
    directly and its decode steps wrap the ring; a 12-token prompt rolls."""
    jcfg, jp, cfg, p = pair
    B = 2
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S + steps))
    jm, m = JLM(jcfg), LM(cfg)
    jc, c = jm.init_cache(B, 32), m.init_cache(B, 32, "cpu")
    assert c["k"].shape[3] == 8
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tl, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])}, c)
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    for key in CACHE_KEYS:
        np.testing.assert_allclose(_np(c[key]), _np(jc[key]), **MODEL_TOL)
    for i in range(steps):
        pos = S + i
        step = toks[:, pos:pos + 1]
        jl, jc = jax.jit(jm.decode_step)(jp, {"tokens": jnp.asarray(step)}, jc, pos)
        tl, c = m.decode_step(p, {"tokens": torch.from_numpy(step)}, c, pos)
        np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
        for key in CACHE_KEYS:
            np.testing.assert_allclose(_np(c[key]), _np(jc[key]), **MODEL_TOL)


def test_backbone_without_cache_matches_reference(pair):
    """The cache-free forward: the LRU scan from a zero state, windowed
    attention over the sequence itself."""
    jcfg, jp, cfg, p = pair
    x = np.random.default_rng(3).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jy, _ = JLM(jcfg).backbone(jp, jnp.asarray(x), positions=jnp.arange(11))
    ty, _ = LM(cfg).backbone(p, torch.from_numpy(x), positions=torch.arange(11))
    np.testing.assert_allclose(_np(ty), _np(jy), **MODEL_TOL)


def _traffic(vocab, lens, max_new, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (n,)).astype(np.int32), max_new) for n in lens]


@pytest.mark.parametrize("lens", [
    [16] * 5,                        # the launcher's traffic: every prompt rolls the ring
    [5, 12, 9, 12],                  # ragged (ROADMAP C4 kept on purpose); decode wraps
], ids=["equal", "ragged"])
def test_serving_engine_tokens_match_reference(pair, lens):
    jcfg, jp, cfg, p = pair
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
    assert teng.prefill_calls == len(lens) and teng.decode_calls > 0


def test_prefill_then_decode_matches_longer_prefill():
    """The port's own consistency: prefill(t[:n]) then decode(t[n]) gives
    prefill(t[:n+1])'s last logits (n past the window: the ring rolled)."""
    cfg = get_config(ARCH, reduced=True)
    m = LM(cfg)
    p = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 14)))
    _, cache = m.prefill(p, {"tokens": toks[:, :13]}, m.init_cache(2, 32, "cpu"))
    step, _ = m.decode_step(p, {"tokens": toks[:, 13:14]}, cache, 13)
    full, _ = m.prefill(p, {"tokens": toks}, m.init_cache(2, 32, "cpu"))
    np.testing.assert_allclose(_np(step), _np(full), rtol=1e-5, atol=1e-5)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_full_width_params_match_reference_shapes():
    cfg = get_config(ARCH)
    mine = dict(_flatten(init_params(cfg, device="meta")))
    theirs = jax.eval_shape(lambda: j_init_params(j_get_config(ARCH), jax.random.PRNGKey(0)))
    flat = {jax.tree_util.keystr(k).replace("['", "").replace("']", "/").rstrip("/"): v
            for k, v in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert set(mine) == set(flat)
    for k, v in mine.items():
        assert tuple(v.shape) == tuple(flat[k].shape), k
        assert str(v.dtype).replace("torch.", "") == str(flat[k].dtype), k
    n = sum(v.numel() for v in mine.values())
    assert 9.3e9 < n < 9.5e9          # 26 LRU + 12 attention blocks with w_r/w_i
    # ROADMAP C6: the config's own count takes 25 LRU / 13 attention layers
    # and leaves out w_r and w_i
    assert 8.4e9 < cfg.param_count() < 8.6e9


def test_serve_launcher_runs_recurrentgemma_on_cpu(capsys):
    port_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out
