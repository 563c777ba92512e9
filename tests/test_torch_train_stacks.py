"""Training the MoE, SSM and hybrid stacks: the port against the live JAX
reference on the CPU.

The reference's Pallas kernels have no VJP (``jax.vjp`` through
``moe_gmm``, ``ssd_intra_chunk`` and ``rglru_scan`` fails to linearize),
so each backward's plain version is held against ``jax.vjp`` of the
reference's pure-jnp counterpart: ``kernels.ref.moe_gmm_ref``,
``kernels.ref.rglru_scan_ref`` and the model-level chunked scan
``models.mamba2.ssd_chunked`` at more than one chunk.  Each autograd
Function passes ``torch.autograd.gradcheck`` in float64; ``LM.loss`` and
every gradient leaf of reduced granite-moe, deepseek-v2, mamba2 and
recurrentgemma match ``jax.value_and_grad`` of the reference's loss on its
own weights, and five ``Trainer.fit`` steps match the reference's
``Trainer``.  Inputs are drawn with NumPy from a seed.  On the CPU the port
runs its plain versions: no kernel launches.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.training.data import DataConfig as JDataConfig  # noqa: E402
from repro.training.data import synthetic_stream as j_stream  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.models import LM, params_from_reference  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402
from repro_torch.training.data import DataConfig, synthetic_stream  # noqa: E402

torch.set_num_threads(1)

#: float32 end to end: the two packages sum in other orders
TOL32 = dict(rtol=1e-4, atol=1e-5)
F64 = torch.float64


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _counts():
    return (MG.moe_gmm.launches, MG.moe_gmm_bwd.launches, SSD.ssd_intra_chunk.launches,
            SSD.ssd_intra_chunk_bwd.launches, RG.rglru_scan.launches,
            RG.rglru_scan_bwd.launches)


# ---------------------------------------------------------------------------
# each backward's plain version against jax.vjp of the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E, C, D, F, scale", [(4, 10, 64, 32, None), (3, 9, 24, 40, 0.3)])
def test_moe_gmm_bwd_plain_matches_reference_vjp(E, C, D, F, scale):
    rng = np.random.default_rng(E * 100 + C)
    sd = scale or D ** -0.5
    sf = scale or F ** -0.5
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    wg = (sd * rng.standard_normal((E, D, F))).astype(np.float32)
    wu = (sd * rng.standard_normal((E, D, F))).astype(np.float32)
    wd = (sf * rng.standard_normal((E, F, D))).astype(np.float32)
    dy = rng.standard_normal((E, C, D)).astype(np.float32)
    out, vjp = jax.vjp(jref.moe_gmm_ref, *(jnp.asarray(a) for a in (x, wg, wu, wd)))
    want = vjp(jnp.asarray(dy))
    t = [torch.tensor(a) for a in (x, wg, wu, wd)]
    got = MG.moe_gmm_bwd_plain(*t, torch.tensor(dy))
    for name, g, w in zip(("dx", "dwg", "dwu", "dwd"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **TOL32, err_msg=name)
    # the autograd Function wires the forward and this backward
    leaves = [a.clone().requires_grad_(True) for a in t]
    before = _counts()
    o = ops.moe_gmm(*leaves)
    o.backward(torch.tensor(dy))
    assert _counts() == before
    np.testing.assert_allclose(_np(o), _np(out), **TOL32)
    for name, leaf, w in zip(("dx", "dwg", "dwu", "dwd"), leaves, want):
        np.testing.assert_allclose(_np(leaf.grad), _np(w), **TOL32, err_msg=name)


@pytest.mark.parametrize("B, L, W, with_hT", [(2, 13, 8, True), (1, 1, 5, True),
                                              (3, 20, 6, False)])
def test_rglru_scan_bwd_plain_matches_reference_vjp(B, L, W, with_hT):
    rng = np.random.default_rng(L * 10 + W)
    x, r, i = (rng.standard_normal((B, L, W)).astype(np.float32) for _ in range(3))
    lam = rng.standard_normal(W).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    dh = rng.standard_normal((B, L, W)).astype(np.float32)
    dht = rng.standard_normal((B, W)).astype(np.float32) if with_hT else np.zeros((B, W),
                                                                                 np.float32)
    (hs, _), vjp = jax.vjp(jref.rglru_scan_ref, *(jnp.asarray(a) for a in (x, r, i, lam, h0)))
    want = vjp((jnp.asarray(dh), jnp.asarray(dht)))
    t = [torch.tensor(a) for a in (x, r, i, lam, h0)]
    out, _ = RG.rglru_scan_plain(*t)
    np.testing.assert_allclose(_np(out), _np(hs), **TOL32)
    got = RG.rglru_scan_bwd_plain(*t, out, torch.tensor(dh),
                                  torch.tensor(dht) if with_hT else None)
    for name, g, w in zip(("dx", "dr", "di", "dlam", "dh0"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL32, err_msg=name)
    leaves = [a.clone().requires_grad_(True) for a in t]
    before = _counts()
    h, h_t = ops.rglru_scan(*leaves)
    loss = (h * torch.tensor(dh)).sum() + ((h_t * torch.tensor(dht)).sum() if with_hT else 0)
    loss.backward()
    assert _counts() == before
    for name, leaf, w in zip(("dx", "dr", "di", "dlam", "dh0"), leaves, want):
        np.testing.assert_allclose(_np(leaf.grad), _np(w), **TOL32, err_msg=name)


#: (B, L, H, P, N, chunk, init_state): nb = 2, 3 (ragged: padded with
#: dt = 0) and 4, so gradient flows through contrib and chunk_decay
SSD_SHAPES = [(2, 32, 3, 8, 16, 16, False), (1, 40, 2, 4, 8, 16, True),
              (2, 64, 4, 16, 16, 16, True)]


@pytest.mark.parametrize("B, L, H, P, N, chunk, init", SSD_SHAPES)
def test_ssd_chunked_grads_match_reference_model_level_vjp(B, L, H, P, N, chunk, init):
    """``ops.ssd_chunked`` (``SsdIntraChunkFn`` and the inter-chunk scan in
    torch) under autograd against ``jax.vjp`` of the reference's
    model-level chunked scan, cotangents on y and the final state."""
    rng = np.random.default_rng(L + H)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, 1, N)).astype(np.float32) for _ in range(2))
    s0 = (0.1 * rng.standard_normal((B, H, P, N))).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    ins = [x, dt, A, Bm, Cm] + ([s0] if init else [])

    def jf(x, dt, A, Bm, Cm, s0=None):
        return j_ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)

    (jy, jst), vjp = jax.vjp(jf, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    before = _counts()
    y, st = ops.ssd_chunked(*leaves[:5], chunk=chunk,
                            init_state=leaves[5] if init else None)
    ((y * torch.tensor(dy)).sum() + (st * torch.tensor(ds)).sum()).backward()
    assert _counts() == before
    np.testing.assert_allclose(_np(y), _np(jy), **TOL32)
    np.testing.assert_allclose(_np(st), _np(jst), **TOL32)
    names = ("dx", "ddt", "dA", "dB", "dC", "dstate")
    for name, leaf, w in zip(names, leaves, want):
        np.testing.assert_allclose(_np(leaf.grad), _np(w), **TOL32, err_msg=name)


def test_ssd_bwd_plain_takes_missing_gradients_as_zero():
    """A None gradient (an output autograd has no use for) is a zero one."""
    rng = np.random.default_rng(2)
    b, nb, c, h, p, n = 1, 2, 6, 2, 4, 3
    args = [torch.tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((b, nb, c, h, p), (b, nb, c, h), (h,), (b, nb, c, n), (b, nb, c, n))]
    args[1] = args[1].abs()
    args[2] = -args[2].abs()
    grads = [torch.tensor(rng.standard_normal(s).astype(np.float32))
             for s in ((b, nb, c, h, p), (b, nb, h, p, n), (b, nb, h))]
    for keep in range(3):
        given = [g if k == keep else None for k, g in enumerate(grads)]
        zeros = [g if k == keep else torch.zeros_like(g) for k, g in enumerate(grads)]
        for a, z in zip(SSD.ssd_intra_chunk_bwd_plain(*args, *given),
                        SSD.ssd_intra_chunk_bwd_plain(*args, *zeros)):
            torch.testing.assert_close(a, z, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# gradcheck, float64
# ---------------------------------------------------------------------------
def _gradcheck_inputs(kind, rng):
    def t(*shape, lo=None, hi=None):
        a = rng.standard_normal(shape)
        if lo is not None:
            a = rng.uniform(lo, hi, shape)
        return torch.tensor(a, dtype=F64, requires_grad=True)

    if kind == "moe_gmm":
        return MG.MoeGmmFn, (t(2, 3, 4), t(2, 4, 5), t(2, 4, 5), t(2, 5, 4))
    if kind == "rglru_scan":
        return RG.RglruScanFn, (t(2, 5, 3), t(2, 5, 3), t(2, 5, 3), t(3), t(2, 3))
    return SSD.SsdIntraChunkFn, (t(1, 2, 4, 2, 3), t(1, 2, 4, 2, lo=0.1, hi=1.0),
                                 t(2, lo=-1.0, hi=-0.2), t(1, 2, 4, 3), t(1, 2, 4, 3))


@pytest.mark.parametrize("kind", ["moe_gmm", "rglru_scan", "ssd_intra_chunk"])
def test_autograd_functions_pass_gradcheck(kind):
    fn, inputs = _gradcheck_inputs(kind, np.random.default_rng(len(kind)))
    assert torch.autograd.gradcheck(fn.apply, inputs, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_ops_launch_the_forward_alone_without_autograd():
    """Serving (no grad) takes the forward as before: the same bits with
    and without an input that requires grad."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 5, 8)).astype(np.float32))
    w = [torch.tensor((0.3 * rng.standard_normal(s)).astype(np.float32))
         for s in ((2, 8, 6), (2, 8, 6), (2, 6, 8))]
    plain = ops.moe_gmm(x, *w)
    assert plain.grad_fn is None
    traced = ops.moe_gmm(x, *(a.clone().requires_grad_(True) for a in w))
    assert traced.grad_fn is not None
    torch.testing.assert_close(traced.detach(), plain, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.moe_gmm(x, *(a.clone().requires_grad_(True) for a in w)).grad_fn is None


# ---------------------------------------------------------------------------
# the model's loss and the trainer
# ---------------------------------------------------------------------------
#: (arch, batch, seq): mamba2's seq 64 is 4 of its 16-token chunks;
#: recurrentgemma's 20 tokens pass its reduced window of 8
LOSS_CASES = [("granite_moe_1b", 2, 12, {}), ("deepseek_v2_236b", 2, 12, {}),
              ("mamba2_2p7b", 2, 64, {}), ("mamba2_2p7b", 1, 40, {"remat": False}),
              ("recurrentgemma_9b", 2, 20, {})]


def _both(arch, **replace):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        cfg = dataclasses.replace(cfg, **replace)
    return jcfg, cfg


@pytest.mark.parametrize("arch, batch, seq, replace", LOSS_CASES)
def test_lm_loss_and_grads_match_reference(arch, batch, seq, replace):
    jcfg, cfg = _both(arch, **replace)
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    p = params_from_reference(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                              device="cpu")
    for _, leaf in _leaves(p):
        leaf.requires_grad_(True)
    data = DataConfig(batch=batch, seq_len=seq, seed=4)
    bt = next(synthetic_stream(cfg, data, device="cpu"))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in bt.items()}
    jl, jg = jax.value_and_grad(JLM(jcfg).loss)(jp, jbatch)
    before = _counts()
    tl = LM(cfg).loss(p, bt)
    tl.backward()
    assert _counts() == before
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    names = [n for n, _ in _leaves(p)]
    assert names == [n for n, _ in _leaves(jg)]
    for (name, a), (_, b) in zip(_leaves(p), _leaves(jg)):
        assert a.grad is not None, name
        np.testing.assert_allclose(_np(a.grad), _np(b), **TOL32, err_msg=name)


def _ref_state(t):
    return {"params": t.params, "opt_state": t.opt_state, "step": t.step}


@pytest.mark.parametrize("arch, seq", [("granite_moe_1b", 16), ("mamba2_2p7b", 32),
                                       ("recurrentgemma_9b", 16)])
def test_trainer_fit_matches_reference(tmp_path, arch, seq):
    """Five steps from the reference's step-0 state (carried by its
    checkpoint) on the same stream: losses at rtol 1e-4, parameters at
    atol 1e-5, as tests/test_torch_train.py holds the dense stack."""
    jcfg, cfg = _both(arch)
    steps = 5
    dcfg = dict(batch=4, seq_len=seq, seed=2)
    jt = JTrainer(jcfg, JTrainConfig(steps=steps, log_every=1), seed=0)
    JCheckpointManager(str(tmp_path)).save(0, _ref_state(jt))
    t = Trainer(cfg, TrainConfig(steps=steps, log_every=1, checkpoint_dir=str(tmp_path),
                                 checkpoint_every=1000), device="cpu")
    assert t.restore_if_available()
    jres = jt.fit(j_stream(jcfg, JDataConfig(**dcfg)))
    tres = t.fit(synthetic_stream(cfg, DataConfig(**dcfg), device="cpu"))
    assert tres["final_step"] == jres["final_step"] == steps
    for a, b in zip(tres["history"], jres["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    for (name, a), (_, b) in zip(_leaves(t.params), _leaves(jt.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5, err_msg=name)
