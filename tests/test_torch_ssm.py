"""The port's Mamba-2 path against the live JAX reference: the SSD
intra-chunk kernel's plain version and the port's oracle against the
Pallas kernel (interpret mode), ``ops.ssd_chunked`` against the
reference's op and its model-level chunked scan, and the reduced mamba2
config end to end on the reference's own weights (``params_from_reference``).

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
from repro.kernels.ssd import ssd_intra_chunk as j_ssd_intra_chunk  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import LM, init_params, params_from_reference  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked as t_ssd_chunked  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)

ARCH = "mamba2_2p7b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    """tests/test_kernels.py's SSD tolerances (test_ssd_kernel_sweep)."""
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)


#: float32 end to end on the reduced config; sums reduced in another order
MODEL_TOL = dict(rtol=0, atol=1e-4)


def _pair(x, dtype="float32"):
    x = np.asarray(x, np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _ssd_inputs(seed, b, l, h, p, n, dtype, chunked=None):
    """x, dt (softplus'd, f32), A (< 0), Bm, Cm as (jax, torch) pairs; with
    ``chunked=(nb, c)`` in the kernel's chunk-major layout."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    Bm = rng.standard_normal((b, l, 1, n))
    Cm = rng.standard_normal((b, l, 1, n))
    if chunked:
        nb, c = chunked
        x = x.reshape(b, nb, c, h, p)
        dt = dt.reshape(b, nb, c, h)
        Bm = Bm.reshape(b, nb, c, n)
        Cm = Cm.reshape(b, nb, c, n)
    return (_pair(x, dtype), _pair(dt), _pair(A), _pair(Bm, dtype), _pair(Cm, dtype))


# ---------------------------------------------------------------------------
# the intra-chunk kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,nb,c,h,p,n", [
    (1, 4, 16, 4, 16, 16),      # tests/test_kernels.py's sweep shapes
    (2, 3, 32, 8, 32, 32),
    (1, 1, 16, 8, 64, 128),     # the serve prefill's per-head widths
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssd_intra_chunk_matches_pallas_and_oracle(b, nb, c, h, p, n, dtype):
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _ssd_inputs(
        b * 100 + c, b, nb * c, h, p, n, dtype, chunked=(nb, c))
    got = SSD.ssd_intra_chunk(tx, tdt, tA, tB, tC)
    pallas = j_ssd_intra_chunk(jx, jdt, jA, jB, jC, head_block=min(8, h), interpret=True)
    mine = ref.ssd_intra_chunk_ref(tx, tdt, tA, tB, tC)
    # the reference's own oracle (kernels/ref.py ssd_intra_chunk_ref) cannot
    # run: its einsum subscripts ("bncn2") are not valid (ROADMAP C8), so the
    # port's copy, with valid subscripts, is held to the Pallas kernel
    for g, pl_, m in zip(got, pallas, mine):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(pl_), **_tol(dtype))
        np.testing.assert_allclose(_np(m), _np(pl_), **_tol(dtype))


# ---------------------------------------------------------------------------
# the full op: intra-chunk part + inter-chunk scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 64, 4, 16, 16, 16),     # tests/test_kernels.py's sweep shapes
    (2, 96, 8, 32, 32, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference_op(b, l, h, p, n, chunk, dtype):
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _ssd_inputs(l + h, b, l, h, p, n, dtype)
    y, fin = ops.ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk)
    assert y.dtype == tx.dtype and fin.dtype == tx.dtype
    jy, jfin = jops.ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(y), _np(jy), **_tol(dtype))
    np.testing.assert_allclose(_np(fin), _np(jfin), **_tol(dtype))


@pytest.mark.parametrize("l,chunk", [(37, 16), (16, 256), (600, 256)])
def test_ssd_chunked_with_init_state_matches_model_scan(l, chunk):
    """Seeded with a nonzero state, over a ragged length: the op equals
    the reference's model-level chunked scan (``models/mamba2.py``) and the
    port's copy of it."""
    b, h, p, n = 2, 4, 8, 16
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _ssd_inputs(l, b, l, h, p, n, "float32")
    s0 = np.random.default_rng(7).standard_normal((b, h, p, n))
    js0, ts0 = _pair(s0)
    y, fin = ops.ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk, init_state=ts0)
    jy, jfin = j_ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk, init_state=js0)
    ty, tfin = t_ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk, init_state=ts0)
    for got in ((y, fin), (ty, tfin)):
        np.testing.assert_allclose(_np(got[0]), _np(jy), **_tol("float32"))
        np.testing.assert_allclose(_np(got[1]), _np(jfin), **_tol("float32"))


def test_ssd_chunked_refuses_groups():
    x = torch.zeros(1, 8, 4, 2)
    with pytest.raises(ValueError, match="group"):
        ops.ssd_chunked(x, torch.zeros(1, 8, 4), torch.zeros(4), torch.zeros(1, 8, 2, 4),
                        torch.zeros(1, 8, 2, 4))


def test_dispatch_takes_the_plain_version_on_cpu_only():
    (_, tx), (_, tdt), (_, tA), (_, tB), (_, tC) = _ssd_inputs(0, 1, 16, 2, 8, 8, "float32",
                                                               chunked=(1, 16))
    n0 = SSD.ssd_intra_chunk.launches
    for a, b_ in zip(SSD.ssd_intra_chunk(tx, tdt, tA, tB, tC),
                     SSD.ssd_intra_chunk_plain(tx, tdt, tA, tB, tC)):
        assert torch.equal(a, b_)
    assert SSD.ssd_intra_chunk.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        SSD.ssd_intra_chunk(tx.to("meta"), tdt, tA, tB, tC)


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args, err", [
    ((_z(1, 1, 4, 2, 8, dtype=torch.float16), _z(1, 1, 4, 2), _z(2),
      _z(1, 1, 4, 8, dtype=torch.float16), _z(1, 1, 4, 8, dtype=torch.float16)), TypeError),
    ((_z(1, 1, 4, 2, 8), _z(1, 1, 4, 2, dtype=torch.bfloat16), _z(2), _z(1, 1, 4, 8),
      _z(1, 1, 4, 8)), TypeError),
    ((_z(1, 1, 4, 2, 8), _z(1, 1, 4, 3), _z(2), _z(1, 1, 4, 8), _z(1, 1, 4, 8)), ValueError),
    ((_z(1, 1, 4, 2, 12), _z(1, 1, 4, 2), _z(2), _z(1, 1, 4, 8), _z(1, 1, 4, 8)), ValueError),
    ((_z(1, 1, 300, 2, 8), _z(1, 1, 300, 2), _z(2), _z(1, 1, 300, 8), _z(1, 1, 300, 8)),
     ValueError),
    ((_z(1, 1, 4, 2, 8), _z(1, 1, 4, 2), _z(2), _z(1, 1, 4, 512), _z(1, 1, 4, 512)),
     ValueError),
])
def test_ssd_cuda_wrapper_validates_before_launch(args, err):
    with pytest.raises(err):
        SSD._ssd_intra_chunk_cuda(*args)


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
        assert dataclasses.asdict(get_config(ARCH, reduced=reduced)) == \
            dataclasses.asdict(j_get_config(ARCH, reduced=reduced))


@pytest.mark.parametrize("S", [8, 40], ids=["one_chunk", "three_chunks_padded"])
def test_prefill_and_decode_match_reference(pair, S):
    jcfg, jp, cfg, p = pair
    B = 2
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S + 3))
    jm, m = JLM(jcfg), LM(cfg)
    jc, c = jm.init_cache(B, 64), m.init_cache(B, 64, "cpu")
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tl, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])}, c)
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(_np(c[key]), _np(jc[key]), **MODEL_TOL)
    for i in range(3):
        pos = S + i
        step = toks[:, pos:pos + 1]
        jl, jc = jax.jit(jm.decode_step)(jp, {"tokens": jnp.asarray(step)}, jc, pos)
        tl, c = m.decode_step(p, {"tokens": torch.from_numpy(step)}, c, pos)
        np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(_np(c[key]), _np(jc[key]), **MODEL_TOL)


def test_cache_dtypes_follow_reference_in_bfloat16():
    """In bf16 the reference's decode step returns a float32 SSM state, so
    its cache turns float32 after the first decode; the port's does too."""
    jcfg = dataclasses.replace(j_get_config(ARCH, reduced=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="bfloat16")
    jm, m = JLM(jcfg), LM(cfg)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    p = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = np.zeros((2, 6), np.int64)
    jc, c = jm.init_cache(2, 16), m.init_cache(2, 16, "cpu")
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :5])}, jc)
    _, c = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :5])}, c)
    assert {k: str(v.dtype) for k, v in c.items()} == \
        {k: "torch." + str(v.dtype) for k, v in jc.items()}
    _, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, 5:])}, jc, 5)
    _, c = m.decode_step(p, {"tokens": torch.from_numpy(toks[:, 5:])}, c, 5)
    assert {k: str(v.dtype) for k, v in c.items()} == \
        {k: "torch." + str(v.dtype) for k, v in jc.items()}


def _traffic(vocab, lens, max_new, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (n,)).astype(np.int32), max_new) for n in lens]


@pytest.mark.parametrize("lens", [
    [16] * 5,                     # the launcher's traffic: one chunk each
    [37, 5, 20, 12],              # ragged, several chunks and a padded tail
], ids=["equal", "ragged_multichunk"])
def test_serving_engine_tokens_match_reference(pair, lens):
    jcfg, jp, cfg, p = pair
    traffic = _traffic(cfg.vocab_size, lens, max_new=6)
    jeng = JServingEngine(jcfg, jp, JEngineConfig(max_batch=4, max_len=64))
    teng = ServingEngine(cfg, p, EngineConfig(max_batch=4, max_len=64), device="cpu")
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
    prefill(t[:n+1])'s last logits (n spans two chunks)."""
    cfg = get_config(ARCH, reduced=True)
    m = LM(cfg)
    p = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 21)))
    _, cache = m.prefill(p, {"tokens": toks[:, :20]}, m.init_cache(2, 32, "cpu"))
    step, _ = m.decode_step(p, {"tokens": toks[:, 20:21]}, cache, 20)
    full, _ = m.prefill(p, {"tokens": toks}, m.init_cache(2, 32, "cpu"))
    np.testing.assert_allclose(_np(step), _np(full), rtol=1e-5, atol=1e-5)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_full_width_params_match_reference_shapes():
    mine = dict(_flatten(init_params(get_config(ARCH), device="meta")))
    theirs = jax.eval_shape(lambda: j_init_params(j_get_config(ARCH), jax.random.PRNGKey(0)))
    flat = {jax.tree_util.keystr(k).replace("['", "").replace("']", "/").rstrip("/"): v
            for k, v in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert set(mine) == set(flat)
    for k, v in mine.items():
        assert tuple(v.shape) == tuple(flat[k].shape), k
        assert str(v.dtype).replace("torch.", "") == str(flat[k].dtype), k
    n = sum(v.numel() for v in mine.values())
    assert 2.6e9 < n < 2.8e9      # mamba2-2.7b: 2.70 B in the reference's tree


def test_serve_launcher_runs_mamba2_on_cpu(capsys):
    port_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out
