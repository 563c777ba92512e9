"""Meshes, ``ElasticMesh``, the checkpoint across meshes and the
production-mesh dry run's accounting, on the CPU.

Meshes are built under ``torch.distributed``'s fake process group (opened
and closed inside each test: the group is process-global).
``ElasticMesh``'s grids are held against the reference's on stub devices
carrying ``.id``.  The dry run's flop count is exact for a matmul-only
step and its collectives are those ``CommDebugMode`` counts; a reduced
phi4-mini train cell on one rank is held against the reference's
loop-weighted HLO flops (``weighted_costs``) of the same step.
"""
import contextlib
import os
import socket

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.distribution.elastic import ElasticMesh as JElasticMesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distribution import ElasticMesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh  # noqa: E402

torch.set_num_threads(1)


class Dev:
    """A device stub: the reference's mesh helpers read only ``.id``."""

    def __init__(self, i):
        self.id = i

    def __repr__(self):
        return f"Dev({self.id})"


def test_production_meshes_under_a_fake_group():
    with dryrun.fake_world(256):
        m = make_production_mesh()
        assert tuple(m.shape) == (16, 16) and m.mesh_dim_names == ("data", "model")
        assert m.device_type == "cpu"
    assert not dist.is_initialized()
    with dryrun.fake_world(512):
        m = make_production_mesh(multi_pod=True)
        assert tuple(m.shape) == (2, 16, 16)
        assert m.mesh_dim_names == ("pod", "data", "model")
    with dryrun.fake_world(8):
        m = make_mesh_for(8, model_parallel=2)
        assert tuple(m.shape) == (4, 2) and m.mesh_dim_names == ("data", "model")


def test_fake_world_refuses_a_second_group():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="already open"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("n, mp, failed", [(8, 2, [5]), (10, 4, [0]), (16, 4, [3, 14]),
                                           (7, 1, [6]), (12, 3, [])])
def test_elastic_mesh_grids_equal_reference(n, mp, failed):
    devs = [Dev(i) for i in range(n)]
    ref = JElasticMesh(model_parallel=mp).mesh_for(devs)
    want = [[d.id for d in row] for row in ref.devices]
    assert ElasticMesh.grid(devs, mp).tolist() == want
    assert ElasticMesh.grid(range(n), mp).tolist() == want
    with dryrun.fake_world(n):
        mesh = ElasticMesh(model_parallel=mp).mesh_for()
        assert mesh.mesh.tolist() == want and mesh.mesh_dim_names == ("data", "model")
        if not failed:
            return
        rows = [[d.id for d in row] for row in JElasticMesh(mp).shrink(
            ref, [Dev(i) for i in failed]).devices]
        shrunk = ElasticMesh(mp).shrink(mesh, [Dev(i) for i in failed])
        assert shrunk.mesh.tolist() == rows
        assert ElasticMesh(mp).shrink(mesh, failed).mesh.tolist() == rows


def test_elastic_mesh_errors_as_reference():
    with pytest.raises(RuntimeError, match="not enough devices"):
        ElasticMesh(model_parallel=4).grid(range(3), 4)
    with pytest.raises(RuntimeError, match="no healthy"):
        ElasticMesh.shrink_grid(np.arange(4).reshape(2, 2), [0, 3])


# ---------------------------------------------------------------------------
# the checkpoint across meshes
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def gloo_world():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite_moe_1b", "mamba2_2p7b"])
def test_checkpoint_saved_on_a_mesh_resumes_without_one(tmp_path, arch):
    """Save gathers full tensors; the same payload restores into DTensors
    (each rank its shard) or plain tensors, and the next loss is the
    uninterrupted run's, bit for bit (a one-rank mesh: every placement
    whole)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.training.data import DataConfig, synthetic_stream

    cfg = get_config(arch, reduced=True)
    dcfg = DataConfig(batch=2, seq_len=16, seed=3)
    plain = Trainer(cfg, TrainConfig(steps=3, log_every=1), device="cpu")
    want = plain.fit(synthetic_stream(cfg, dcfg, device="cpu"))["history"]
    with gloo_world():
        mesh = ElasticMesh(1).mesh_for()
        t = Trainer(cfg, TrainConfig(steps=2, log_every=1, checkpoint_dir=str(tmp_path),
                                     checkpoint_every=2), mesh=mesh, device="cpu")
        got = t.fit(synthetic_stream(cfg, dcfg, device="cpu"))["history"]
        assert all(isinstance(p, DTensor) for p in t.params["layers"].values()
                   if not isinstance(p, dict))
        # and back onto the mesh from the same payload
        back = Trainer(cfg, TrainConfig(steps=3, log_every=1, checkpoint_dir=str(tmp_path)),
                       mesh=mesh, device="cpu")
        assert back.restore_if_available() and back.step == 2
        on_mesh = back.fit(synthetic_stream(cfg, dcfg, start_step=2, device="cpu"))["history"]
    off = Trainer(cfg, TrainConfig(steps=3, log_every=1, checkpoint_dir=str(tmp_path)),
                  device="cpu")
    assert off.restore_if_available() and off.step == 2
    resumed = off.fit(synthetic_stream(cfg, dcfg, start_step=2, device="cpu"))["history"]
    assert [h["loss"] for h in got] == [h["loss"] for h in want[:2]]
    assert resumed[-1]["loss"] == on_mesh[-1]["loss"] == want[2]["loss"]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
def test_run_cell_refuses_cuda():
    with pytest.raises(ValueError, match="never on cuda"):
        dryrun.run_cell("granite_moe_1b", "train_4k", device="cuda")


def test_run_cell_skips_long_context_for_full_attention():
    res = dryrun.run_cell("phi4_mini_3p8b", "long_500k")
    assert res["status"] == "SKIP(full-attention)"


def test_step_counter_flops_exact_and_collectives_as_comm_debug_mode():
    """A matmul-only step on a (2, 2) fake mesh: x (64, 128) batch-sharded
    over 'data' times w (128, 256) column-sharded over 'model', then the
    row-parallel product back: per-device flops are exactly the global
    ones over the ranks sharing the work, and the collectives are the ops
    CommDebugMode counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.analysis.trace import StepCounter

    with dryrun.fake_world(4):
        mesh = make_mesh_for(4, model_parallel=2)
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(64, 128), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w1 = distribute_tensor(torch.empty(128, 256), mesh, [Replicate(), Shard(1)],
                                   src_data_rank=None)
            w2 = distribute_tensor(torch.empty(256, 128), mesh, [Replicate(), Shard(0)],
                                   src_data_rank=None)
            comm = CommDebugMode()
            with comm, StepCounter() as c:
                y = (x @ w1) @ w2
                y = y.redistribute(mesh, [Shard(0), Replicate()])
    counts = c.counts()
    assert counts["flops"] == (2 * 64 * 128 * 256 + 2 * 64 * 256 * 128) / 4
    want = {str(op).split(".")[-1]: n for op, n in comm.get_comm_counts().items()}
    assert want == {"all_reduce": 1}
    assert counts["collective_ops"] == {"all-reduce": 1}
    # the all-reduce's operand: this rank's (32, 128) float32 partial sum
    assert counts["collective"]["all-reduce"] == 32 * 128 * 4
    assert counts["collective"]["total"] == 32 * 128 * 4


#: the port's per-device flops of a reduced phi4-mini train cell (batch 4
#: x 64) on one rank over the reference's loop-weighted HLO dot flops of
#: the same step: measured 1.0379 (287309824 / 276824064).  Both count the
#: matmuls, the remat recompute and the blocked attention's products; the
#: port's backward of the blocked attention (its plain ``_flash_bwd``)
#: has a few more.  Pinned within a band around the reading.
PHI4_FLOPS_RATIO = (1.00, 1.08)


def test_train_cell_flops_against_reference_weighted_costs():
    import jax.numpy as jnp

    from repro.analysis.costs import weighted_costs
    from repro.configs import get_config as j_config
    from repro.models import LM as JLM
    from repro.models import init_params as j_init
    from repro.training.optimizer import AdamWConfig, adamw_init, adamw_update

    shape = ShapeSpec("train_4k", 64, 4, "train")
    res = dryrun.run_cell("phi4_mini_3p8b", "train_4k", shape=shape, mesh_shape=(1, 1),
                          cfg=get_config("phi4_mini_3p8b", reduced=True), verbose=False)
    jcfg = j_config("phi4_mini_3p8b", reduced=True)
    model = JLM(jcfg)
    params = jax.eval_shape(lambda: j_init(jcfg, jax.random.PRNGKey(0)))
    opt = jax.eval_shape(lambda: adamw_init(params, "float32"))
    batch = {k: jax.ShapeDtypeStruct((shape.global_batch, shape.seq_len), jnp.int32)
             for k in ("tokens", "labels")}

    def step(p, o, b):
        loss, g = jax.value_and_grad(model.loss)(p, b)
        return adamw_update(AdamWConfig(), p, g, o)

    text = jax.jit(step).lower(params, opt, batch).compile().as_text()
    ref = weighted_costs(text)["flops"]
    ratio = res["roofline"]["flops_per_device"] / ref
    lo, hi = PHI4_FLOPS_RATIO
    assert lo <= ratio <= hi, ratio


# ---------------------------------------------------------------------------
# kernels and DTensors
# ---------------------------------------------------------------------------
def _replicated(mesh, *shapes, seed=0):
    from torch.distributed.tensor import Replicate, distribute_tensor

    g = torch.Generator().manual_seed(seed)
    return [distribute_tensor(torch.randn(s, generator=g), mesh, [Replicate(), Replicate()])
            for s in shapes]


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_bwd", "moe_gmm",
                                    "moe_gmm_bwd", "ssd_intra_chunk", "rglru_scan",
                                    "rglru_scan_bwd"])
def test_a_dtensor_reaching_a_kernel_wrapper_raises(kernel):
    """The wrappers read raw pointers on the card; on the CPU too a DTensor
    is refused, never unwrapped quietly (kernels/ops.py runs them on local
    shards)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gmm as MG
    from repro_torch.kernels import rglru as RG
    from repro_torch.kernels import ssd as SSD

    with gloo_world():
        mesh = ElasticMesh(1).mesh_for()
        if kernel.startswith("flash"):
            q, k, v = _replicated(mesh, (1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))
            call = (lambda: FA.flash_attention(q, k, v)) if kernel == "flash_attention" else \
                (lambda: FA.flash_attention_bwd(q, k, v, q, q[..., 0], q))
        elif kernel.startswith("moe"):
            x, wg, wu, wd = _replicated(mesh, (2, 8, 16), (2, 16, 32), (2, 16, 32), (2, 32, 16))
            call = (lambda: MG.moe_gmm(x, wg, wu, wd)) if kernel == "moe_gmm" else \
                (lambda: MG.moe_gmm_bwd(x, wg, wu, wd, x))
        elif kernel == "ssd_intra_chunk":
            x, dt, A, B = _replicated(mesh, (1, 2, 8, 3, 4), (1, 2, 8, 3), (3,), (1, 2, 8, 16))
            call = lambda: SSD.ssd_intra_chunk(x, dt, A, B, B)  # noqa: E731
        else:
            x, lam, h0 = _replicated(mesh, (2, 5, 16), (16,), (2, 16))
            call = (lambda: RG.rglru_scan(x, x, x, lam, h0)) if kernel == "rglru_scan" else \
                (lambda: RG.rglru_scan_bwd(x, x, x, lam, h0, x, x))
        with pytest.raises(TypeError, match="DTensor reached the kernel wrapper"):
            call()


def test_ops_run_the_kernels_on_local_shards():
    """Through the dispatch layer a DTensor call runs the wrapper on the
    local shards and equals the plain call (a one-rank mesh)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    with gloo_world():
        mesh = ElasticMesh(1).mesh_for()
        q, k, v = _replicated(mesh, (2, 4, 8, 16), (2, 2, 8, 16), (2, 2, 8, 16), seed=3)
        out = ops.flash_attention(q, k, v, causal=True)
        want = FA.flash_attention(q.to_local(), k.to_local(), v.to_local(), causal=True)
        assert torch.equal(out.full_tensor(), want)
        x, r, i, lam, h0 = _replicated(mesh, (2, 5, 16), (2, 5, 16), (2, 5, 16), (16,), (2, 16))
        y, h = ops.rglru_scan(x, r, i, lam, h0)
        y0, h1 = ops.rglru_scan(x.to_local(), r.to_local(), i.to_local(), lam.to_local(),
                                h0.to_local())
        assert torch.equal(y.full_tensor(), y0) and torch.equal(h.full_tensor(), h1)
