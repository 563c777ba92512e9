"""The port's training path against the live JAX reference on the CPU:
attention's backward (plain version and ``FlashAttentionFn``) against
``jax.vjp`` of the reference's ``chunked_attention``, ``chunked_xent``,
AdamW and int8 compression, the data stream, the straggler monitor,
checkpoints in both directions (bfloat16 included, ROADMAP C13), ``LM.loss``
and its gradients on reduced phi4-mini with the reference's own weights,
``Trainer.fit`` (plain, accumulated, resumed), every arch accepted for
training, ``ElasticMesh``'s grid rule, and the launcher.  Inputs are drawn with NumPy from a seed.
"""
import dataclasses
import os
import re
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distribution.elastic import StragglerMonitor as JStragglerMonitor  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models.common import chunked_attention as j_chunked  # noqa: E402
from repro.models.common import chunked_xent as j_xent  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.training.data import DataConfig as JDataConfig  # noqa: E402
from repro.training.data import synthetic_stream as j_stream  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distribution import StragglerMonitor  # noqa: E402
from repro_torch.distribution.elastic import ElasticMesh  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import LM, params_from_reference  # noqa: E402
from repro_torch.models.common import chunked_xent  # noqa: E402
from repro_torch.training import AdamWConfig, TrainConfig, Trainer  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.data import DataConfig, Prefetcher, synthetic_stream  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: float32 end to end: the two packages sum in other orders
TOL32 = dict(rtol=1e-4, atol=1e-5)
#: bf16 gradients: both sides form them in float32 and round once to bf16
#: (one ulp is 2^-8 relative); the port's saved ``out`` is the bf16 output
#: where the reference's residual is its float32 output, which moves delta
#: by a bf16 rounding too
TOL16 = dict(rtol=2e-2, atol=2e-2)


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


# ---------------------------------------------------------------------------
# attention's backward
# ---------------------------------------------------------------------------
#: B, Hkv, Lq, Lk, D, q_offset, kv_offset, block: Lq != Lk, nonzero offsets,
#: a block smaller than Lk (three key blocks, the last ragged)
SHAPE = (2, 2, 7, 11, 8, 5, 1, 4)


def _visible_rows(Lq, Lk, qo, ko, causal, window):
    qpos = qo + np.arange(Lq)[:, None]
    kpos = ko + np.arange(Lk)[None, :]
    m = np.ones((Lq, Lk), bool)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m.any(axis=1)


def _bwd_case(G, causal, window, softcap, dtype, seed):
    B, Hkv, Lq, Lk, D, qo, ko, block = SHAPE
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * G, Lq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32)
    do = rng.standard_normal((B, Hkv * G, Lq, D)).astype(np.float32)
    # a row with no visible key gets the mean of V in the reference and 0
    # from the kernel: no training row has one.  Such rows (if the grid
    # makes any) carry no cotangent and are left out of the comparison
    rows = _visible_rows(Lq, Lk, qo, ko, causal, window)
    do[:, :, ~rows] = 0.0
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qo, kv_offset=ko)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: j_chunked(a, b, c, block=block, **kw), jq, jk, jv)
    want = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.tensor(a).to(dtype) for a in (q, k, v))
    return tq, tk, tv, torch.tensor(do).to(dtype), kw, block, rows, out, want


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_bwd_matches_reference_vjp(G, causal, window, softcap):
    tq, tk, tv, tdo, kw, block, rows, jout, (jdq, jdk, jdv) = _bwd_case(
        G, causal, window, softcap, torch.float32, seed=G * 100 + window + int(softcap))
    out, lse = FA.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(_np(out)[:, :, rows], _np(jout)[:, :, rows], **TOL32)
    dq, dk, dv = FA.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, block=block, **kw)
    np.testing.assert_allclose(_np(dq)[:, :, rows], _np(jdq)[:, :, rows], **TOL32)
    np.testing.assert_allclose(_np(dk), _np(jdk), **TOL32)
    np.testing.assert_allclose(_np(dv), _np(jdv), **TOL32)
    # the autograd Function wires the same forward and backward on the CPU
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    o = ops.flash_attention_grad(q, k, v, **kw)
    o.backward(tdo)
    assert (FA.flash_attention.launches, FA.flash_attention_bwd.launches) == before
    np.testing.assert_allclose(_np(o)[:, :, rows], _np(jout)[:, :, rows], **TOL32)
    for got, want in ((q.grad, jdq), (k.grad, jdk), (v.grad, jdv)):
        assert got.dtype == torch.float32
        g, w = _np(got), _np(want)
        if got is q.grad:
            g, w = g[:, :, rows], w[:, :, rows]
        np.testing.assert_allclose(g, w, **TOL32)


@pytest.mark.parametrize("G, window, softcap", [(1, 0, 0.0), (3, 5, 30.0)])
def test_flash_bwd_bf16_matches_reference_vjp(G, window, softcap):
    tq, tk, tv, tdo, kw, block, rows, _jout, want = _bwd_case(
        G, True, window, softcap, torch.bfloat16, seed=7 + G)
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    FA.FlashAttentionFn.apply(q, k, v, True, window, softcap, None, kw["q_offset"],
                              kw["kv_offset"], None).backward(tdo)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(w), **TOL16)


def test_lse_of_split_merge_equals_unsplit():
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.standard_normal((1, 4, 5, 8)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 2, 40, 8)), dtype=torch.float32)
    kw = dict(causal=True, q_offset=30, kv_valid_len=35)
    out, lse = FA.flash_attention_plain(q, k, k, return_lse=True, **kw)
    parts = [FA.flash_partial_plain(q, k, k, lo, lo + 8, **kw) for lo in range(0, 40, 8)]
    o, m, l = (torch.stack(x) for x in zip(*parts))
    got, got_lse = FA.flash_merge_plain(o, m, l, torch.float32, return_lse=True)
    torch.testing.assert_close(got, out, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw, err", [
    (dict(lse=torch.zeros(1, 2, 3, dtype=torch.float64)), ValueError),
    (dict(dout=torch.zeros(1, 2, 4, 8)), ValueError),
    (dict(out=torch.zeros(1, 2, 3, 8, dtype=torch.bfloat16)), TypeError),
])
def test_flash_bwd_cuda_wrapper_validates_before_launch(kw, err):
    args = dict(q=torch.zeros(1, 2, 3, 8), k=torch.zeros(1, 1, 3, 8), v=torch.zeros(1, 1, 3, 8),
                out=torch.zeros(1, 2, 3, 8), lse=torch.zeros(1, 2, 3), dout=torch.zeros(1, 2, 3, 8))
    args.update(kw)
    with pytest.raises(err):
        FA._flash_attention_bwd_cuda(**args, causal=True, window=0, softcap=0.0, scale=None,
                                     q_offset=0, kv_offset=0, kv_valid_len=None)


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_xent_value_and_grad_match_reference(softcap):
    rng = np.random.default_rng(11)
    B, S, D, V = 2, 10, 16, 50
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    emb = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, -3:] = -1     # padded positions carry no loss
    labels[1, 4] = -1
    jf = lambda a, b: j_xent(a, b, jnp.asarray(labels), softcap=softcap, chunk=4)  # noqa: E731
    jl, (jgx, jge) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(emb, requires_grad=True)
    tl = chunked_xent(tx, te, torch.from_numpy(labels), softcap=softcap, chunk=4)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_np(te.grad), _np(jge), rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _random_tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 2)).astype(np.float32)}}


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(pdt, sdt):
    rng = np.random.default_rng(5)
    cfg = dict(lr=1e-2, warmup_steps=2, state_dtype=sdt, grad_clip=1.0)
    p0 = _random_tree(rng)
    grads = [_random_tree(rng) for _ in range(3)]
    jp = _map(lambda a: jnp.asarray(a, pdt), p0)
    js = jopt.adamw_init(jp, sdt)
    tp = _map(lambda a: torch.tensor(a).to(getattr(torch, pdt)), p0)
    ts = topt.adamw_init(tp, sdt)
    for g in grads:
        jg = _map(lambda a: jnp.asarray(a, pdt), g)
        tg = _map(lambda a: torch.tensor(a).to(getattr(torch, pdt)), g)
        jp, js, jgn = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp, jg, js)
        tgn = topt.adamw_update(AdamWConfig(**cfg), tp, tg, ts)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    # float32: ulps of the power and the fused add; bf16: one rounding of
    # each stored value, taken from float32 values equal to those ulps
    tol = dict(rtol=1e-6, atol=1e-7) if pdt == sdt == "float32" else dict(rtol=8e-3, atol=1e-6)
    for (name, a), (_, b) in zip(_leaves(tp), _leaves(jp)):
        assert a.dtype == getattr(torch, pdt), name
        np.testing.assert_allclose(_np(a), _np(b), **tol)
    for key in ("m", "v"):
        for (name, a), (_, b) in zip(_leaves(ts[key]), _leaves(js[key])):
            assert a.dtype == getattr(torch, sdt), name
            np.testing.assert_allclose(_np(a), _np(b), **tol)


def test_global_norm_and_int8_compression_match_reference():
    rng = np.random.default_rng(6)
    tree = _random_tree(rng)
    tree["a"][0, 0] = 0.0
    jt = _map(jnp.asarray, tree)
    tt = _map(torch.tensor, tree)
    np.testing.assert_allclose(float(topt.global_norm(tt)), float(jopt.global_norm(jt)),
                               rtol=1e-6)
    jc, tc = jopt.compress_grads_int8(jt), topt.compress_grads_int8(tt)
    for (name, a), (_, b) in zip(_leaves(tc), _leaves(jc)):
        assert a.dtype == (torch.int8 if name.endswith("q") else torch.float32), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    jd, td = jopt.decompress_grads_int8(jc), topt.decompress_grads_int8(tc)
    for (name, a), (_, b) in zip(_leaves(td), _leaves(jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


# ---------------------------------------------------------------------------
# data and monitoring
# ---------------------------------------------------------------------------
def test_synthetic_stream_bit_identical_to_reference():
    cfg = get_config("phi4_mini_3p8b", reduced=True)
    jcfg = j_get_config("phi4_mini_3p8b", reduced=True)
    dcfg = dict(batch=4, seq_len=16, seed=3)
    ours = synthetic_stream(cfg, DataConfig(**dcfg), start_step=2, device="cpu")
    ref = j_stream(jcfg, JDataConfig(**dcfg), start_step=2)
    pre = Prefetcher(synthetic_stream(cfg, DataConfig(**dcfg), start_step=2, device="cpu"))
    for _ in range(3):
        a, b, c = next(ours), next(ref), next(pre)
        assert set(a) == set(b) == {"tokens", "labels"}
        for key in a:
            assert a[key].dtype == torch.int32
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
            np.testing.assert_array_equal(c[key].numpy(), np.asarray(b[key]))
    pre.close()


def test_straggler_monitor_flags_the_same_steps():
    rng = np.random.default_rng(9)
    dts = list(0.1 + 0.005 * rng.standard_normal(40))
    dts[12] = dts[30] = 0.3
    ours, ref = StragglerMonitor(), JStragglerMonitor()
    flags = [(ours.observe(i, dt), ref.observe(i, dt)) for i, dt in enumerate(dts)]
    assert all(a == b for a, b in flags)
    assert ours.flagged == ref.flagged and 12 in ours.flagged and 30 in ours.flagged
    # ElasticMesh, ported since: the reference's grid rule on stub devices
    from repro.distribution.elastic import ElasticMesh as JElasticMesh

    class Dev:
        def __init__(self, i):
            self.id = i

    devs = [Dev(i) for i in range(7)]
    ref = JElasticMesh(model_parallel=2).mesh_for(devs)
    grid = ElasticMesh(model_parallel=2).grid(devs, 2)
    assert grid.tolist() == [[d.id for d in row] for row in ref.devices]
    shrunk = JElasticMesh(2).shrink(ref, [devs[2]])
    assert ElasticMesh.shrink_grid(grid, [2]).tolist() == \
        [[d.id for d in row] for row in shrunk.devices]


# ---------------------------------------------------------------------------
# the model's loss
# ---------------------------------------------------------------------------
def _phi4(**replace):
    jcfg = j_get_config("phi4_mini_3p8b", reduced=True)
    cfg = get_config("phi4_mini_3p8b", reduced=True)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        cfg = dataclasses.replace(cfg, **replace)
    return jcfg, cfg


@pytest.mark.parametrize("remat, sqrt_remat, layers", [
    (True, False, 3), (False, False, 3), (True, True, 9)])
def test_lm_loss_and_grads_match_reference(remat, sqrt_remat, layers):
    jcfg, cfg = _phi4(remat=remat, num_layers=layers)
    if sqrt_remat:   # the reference reads it with getattr; no config sets it
        object.__setattr__(jcfg, "sqrt_remat", True)
        object.__setattr__(cfg, "sqrt_remat", True)
    from repro.models import init_params as j_init
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    p = params_from_reference(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                              device="cpu")
    for _, leaf in _leaves(p):
        leaf.requires_grad_(True)
    batch = next(synthetic_stream(cfg, DataConfig(batch=2, seq_len=12, seed=4), device="cpu"))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(JLM(jcfg).loss)(jp, jbatch)
    tl = LM(cfg).loss(p, batch)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for (name, a), (_, b) in zip(_leaves(p), _leaves(jg)):
        assert a.grad is not None, name
        np.testing.assert_allclose(_np(a.grad), _np(b), **TOL32, err_msg=name)


def test_stacks_without_a_backward_refuse_to_train():
    """Written while the MoE, SSM and hybrid stacks had no backward and
    refused to train (then ROADMAP A7b), and ``Trainer(mesh=...)`` raised
    (then A8); both are ported now, so ``Trainer`` takes every arch's
    reduced config (its parameters all trainable), and on a one-rank
    mesh each stack's parameters are DTensors placed as ``param_specs``
    says, while a mesh that is no DeviceMesh is refused
    (tests/test_torch_train_stacks.py holds the new stacks' gradients
    against the reference, tests/test_torch_dist_train.py the mesh's)."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS
    from repro_torch.distribution.sharding import param_specs, to_placements

    assert len(ARCHS) == 10
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        t = Trainer(cfg, TrainConfig(steps=1), device="cpu")
        leaves = [leaf for _, leaf in _leaves(t.params)]
        assert leaves and all(leaf.requires_grad for leaf in leaves), arch
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = ElasticMesh(1).mesh_for()
        for arch in ("phi4_mini_3p8b", "granite_moe_1b", "mamba2_2p7b", "recurrentgemma_9b"):
            cfg = get_config(arch, reduced=True)
            with pytest.raises(TypeError, match="DeviceMesh"):
                Trainer(cfg, TrainConfig(), mesh=object(), device="cpu")
            t = Trainer(cfg, TrainConfig(), mesh=mesh, device="cpu")
            specs = dict(_leaves(param_specs(cfg, t.params, fsdp=False)))
            for name, leaf in _leaves(t.params):
                assert isinstance(leaf, DTensor) and leaf.requires_grad, name
                assert tuple(leaf.placements) == to_placements(specs[name], mesh, leaf.shape)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _ref_state(t):
    return {"params": t.params, "opt_state": t.opt_state, "step": t.step}


def test_checkpoints_cross_between_packages(tmp_path):
    jcfg, cfg = _phi4()
    jt = JTrainer(jcfg, JTrainConfig(steps=0), seed=3)
    JCheckpointManager(str(tmp_path / "ref")).save(0, _ref_state(jt))
    t = Trainer(cfg, TrainConfig(steps=0, checkpoint_dir=str(tmp_path / "ref")), device="cpu")
    assert t.restore_if_available() and t.step == 0
    for (name, a), (_, b) in zip(_leaves(t.params), _leaves(jt.params)):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    # a port-written checkpoint (after a step) restores in the reference
    t.train_step(next(synthetic_stream(cfg, DataConfig(batch=2, seq_len=8), device="cpu")))
    t.step = 1
    CheckpointManager(str(tmp_path / "port")).save(1, _ref_state(t))
    tree = JCheckpointManager(str(tmp_path / "port")).restore(1)
    assert int(tree["step"]) == 1 and int(tree["opt_state"]["step"]) == 1
    for key, sub in (("params", t.params), ("opt_state", t.opt_state)):
        for (name, a), (_, b) in zip(_leaves(sub), _leaves(tree[key])):
            np.testing.assert_array_equal(np.asarray(a.detach()), b, err_msg=name)
    jt2 = JTrainer(jcfg, JTrainConfig(steps=0, checkpoint_dir=str(tmp_path / "port")), seed=0)
    assert jt2.restore_if_available() and jt2.step == 1
    for (name, a), (_, b) in zip(_leaves(t.params), _leaves(jt2.params)):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)


def test_bf16_checkpoint_from_reference_restores_bit_for_bit(tmp_path):
    """ROADMAP C13: the reference writes bf16 leaves as ``|V2`` and cannot
    read them back; the port reads the payload as bfloat16."""
    jcfg, cfg = _phi4(dtype="bfloat16")
    jt = JTrainer(jcfg, JTrainConfig(steps=0), seed=1)
    JCheckpointManager(str(tmp_path)).save(0, _ref_state(jt))
    assert np.load(tmp_path / "step_00000000.npz")["params/embed"].dtype == np.dtype("V2")
    t = Trainer(cfg, TrainConfig(steps=0, checkpoint_dir=str(tmp_path)), device="cpu")
    assert t.restore_if_available()
    for (name, a), (_, b) in zip(_leaves(t.params), _leaves(jt.params)):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(a.detach().view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16), err_msg=name)
    # and the port writes them the same way
    CheckpointManager(str(tmp_path / "port")).save(0, _ref_state(t))
    for key in ("params/embed", "params/layers/attn/wq"):
        a = np.load(tmp_path / "port" / "step_00000000.npz")[key]
        b = np.load(tmp_path / "step_00000000.npz")[key]
        assert a.dtype == b.dtype == np.dtype("V2") and a.tobytes() == b.tobytes()


def test_checkpoint_keep_collects_as_the_reference(tmp_path):
    ours = CheckpointManager(str(tmp_path / "a"), keep=2)
    ref = JCheckpointManager(str(tmp_path / "b"), keep=2)
    for s in (1, 3, 4, 7):
        ours.save(s, {"x": torch.full((2,), float(s)), "step": s})
        ref.save(s, {"x": np.full((2,), float(s), np.float32), "step": s})
        assert ours.all_steps() == ref.all_steps()
    assert ours.latest_step() == 7 and ours.all_steps() == [4, 7]
    np.testing.assert_array_equal(ours.restore(7)["x"], ref.restore(7)["x"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _fit_both(tmp_path, accum=1, steps=5):
    """The reference's and the port's trainers from one initial state (the
    reference's, carried by its checkpoint at step 0), ``steps`` steps on
    the same stream."""
    jcfg, cfg = _phi4()
    dcfg = dict(batch=4, seq_len=16, seed=2)
    jt = JTrainer(jcfg, JTrainConfig(steps=steps, log_every=1, grad_accum=accum), seed=0)
    JCheckpointManager(str(tmp_path)).save(0, _ref_state(jt))
    t = Trainer(cfg, TrainConfig(steps=steps, log_every=1, grad_accum=accum,
                                 checkpoint_dir=str(tmp_path), checkpoint_every=1000),
                device="cpu")
    assert t.restore_if_available()

    def split(stream):
        for b in stream:
            yield ({k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in b.items()}
                   if accum > 1 else b)

    jres = jt.fit(split(j_stream(jcfg, JDataConfig(**dcfg))))
    tres = t.fit(split(synthetic_stream(cfg, DataConfig(**dcfg), device="cpu")))
    return jt, jres, t, tres


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_fit_matches_reference(tmp_path, accum):
    jt, jres, t, tres = _fit_both(tmp_path, accum)
    assert tres["final_step"] == jres["final_step"] == 5
    assert [r["step"] for r in tres["history"]] == [1, 2, 3, 4, 5]
    for a, b in zip(tres["history"], jres["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    for (name, a), (_, b) in zip(_leaves(t.params), _leaves(jt.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5, err_msg=name)


def test_grad_accum_needs_the_leading_axis():
    """ROADMAP C12: the reference scans micro-batches over a leading axis
    that a plain batch lacks and fails to unpack; the port says so."""
    cfg = get_config("phi4_mini_3p8b", reduced=True)
    t = Trainer(cfg, TrainConfig(steps=1, grad_accum=2), device="cpu")
    with pytest.raises(ValueError, match="leading accum axis"):
        t.fit(synthetic_stream(cfg, DataConfig(batch=4, seq_len=8), device="cpu"))


def test_trainer_resume_determinism(tmp_path):
    """Crash-and-restore reproduces the uninterrupted run (the reference's
    test_substrate twin, on phi4-mini)."""
    cfg = get_config("phi4_mini_3p8b", reduced=True)
    dcfg = DataConfig(batch=4, seq_len=16, seed=11)

    def run(steps, ckpt_dir, resume=False):
        t = Trainer(cfg, TrainConfig(steps=steps, log_every=1, checkpoint_every=2,
                                     checkpoint_dir=ckpt_dir), seed=1, device="cpu")
        if resume:
            assert t.restore_if_available()
        return t.fit(synthetic_stream(cfg, dcfg, start_step=t.step, device="cpu"))

    full = run(6, str(tmp_path / "a"))
    run(4, str(tmp_path / "b"))                 # "crash" after step 4
    resumed = run(6, str(tmp_path / "b"), resume=True)
    f = {r["step"]: r["loss"] for r in full["history"]}
    r = {r["step"]: r["loss"] for r in resumed["history"]}
    for s in (5, 6):
        assert f[s] == r[s], (s, f[s], r[s])


@pytest.mark.parametrize("extra", [[], ["--grad-accum", "2"]])
def test_launcher_runs_on_the_cpu_in_the_reference_format(extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "phi4_mini_3p8b",
         "--device", "cpu", "--steps", "3", *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert re.fullmatch(r"\[train\] step     1 loss=\d+\.\d{4} gnorm=\d+\.\d{3} dt=\d+ms", lines[0])
    assert lines[-1] == "[train] done at step 3"
