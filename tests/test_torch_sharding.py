"""The port's sharding rules (``distribution/sharding.py``) against the
reference's, on the CPU.

For every arch at full width, the spec of every parameter leaf (FSDP on
and off), cache leaf and batch entry equals the reference's
``PartitionSpec`` entries; the reference's tree is ``jax.eval_shape``'s,
the port's holds meta tensors.  The cases of ``tests/test_substrate.py``
(the spec tree's structure, the cache fallbacks, ``_filter_spec``) are
repeated, and ``to_placements`` is read on DeviceMeshes of a fake
process group.
"""
import os
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as r_config  # noqa: E402
from repro.distribution import sharding as r_sh  # noqa: E402
from repro.launch import dryrun as r_dryrun  # noqa: E402
from repro.models import LM as RLM  # noqa: E402
from repro.models import init_params as r_init  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distribution import sharding as t_sh  # noqa: E402
from repro_torch.launch import dryrun as t_dryrun  # noqa: E402
from repro_torch.models import LM, init_params  # noqa: E402


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _norm(spec):
    """A spec's entries as JAX's ``PartitionSpec`` iterates them: a
    one-axis tuple reads as the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _ref_flat(specs):
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        out[tuple(p.key for p in path)] = tuple(spec)
    return out


@pytest.fixture(scope="module")
def trees():
    """(reference abstract params, port meta params) per arch."""
    out = {}
    for arch in ARCHS:
        rcfg = r_config(arch)
        out[arch] = (jax.eval_shape(lambda c=rcfg: r_init(c, jax.random.PRNGKey(0))),
                     init_params(get_config(arch), device="meta"))
    return out


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(trees, arch, fsdp):
    r_params, t_params = trees[arch]
    want = _ref_flat(r_sh.param_specs(r_config(arch), r_params, fsdp=fsdp))
    got = dict(_flat(t_sh.param_specs(get_config(arch), t_params, fsdp=fsdp)))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec == want[path], path
        assert len(spec) == dict(_flat(t_params))[path].dim()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_reference(arch):
    rcfg, cfg = r_config(arch), get_config(arch)
    r_cache = jax.eval_shape(lambda: RLM(rcfg).init_cache(128, 1024))
    t_cache = LM(cfg).init_cache(128, 1024, device="meta")
    assert set(r_cache) == set(t_cache)
    for shardable in (True, False):
        for model_size in (16, 2):
            want = r_sh.cache_specs(rcfg, r_cache, shardable, model_size=model_size)
            got = t_sh.cache_specs(cfg, t_cache, shardable, model_size=model_size)
            assert {k: tuple(v) for k, v in want.items()} == got
    batch = {"tokens": torch.empty((8, 16), device="meta"),
             "patch_embeds": torch.empty((8, 4, 32), device="meta"),
             "pos": torch.empty((), device="meta")}
    r_batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.float32)
               for k, v in batch.items()}
    assert {k: tuple(v) for k, v in r_sh.batch_specs(rcfg, r_batch).items()} == \
        t_sh.batch_specs(cfg, batch)


def test_param_specs_structure():
    """tests/test_substrate.py's case: experts over 'model', norms replicated."""
    cfg = get_config("deepseek_v2_236b", reduced=True)
    params = init_params(cfg, device="meta")
    specs = t_sh.param_specs(cfg, params, fsdp=True)
    flat = dict(_flat(specs))
    assert set(flat) == {p for p, _ in _flat(params)}
    moe_wg = [s for p, s in flat.items() if "moe" in p and p[-1] == "wg" and "shared" not in p]
    assert moe_wg and all("model" in s for s in moe_wg)
    assert flat[("final_norm",)] == (None,)


def test_cache_specs_fallbacks():
    """tests/test_substrate.py's case: heads shard when they divide 16,
    else the sequence."""
    cfg = get_config("gemma3_4b")  # kv=4
    cache = LM(cfg).init_cache(128, 1024, device="meta")
    specs = t_sh.cache_specs(cfg, cache, batch_shardable=True, model_size=16)
    assert specs["k"] == (None, ("pod", "data"), None, "model", None)
    cfg2 = get_config("gemma2_27b")  # kv=16
    cache2 = LM(cfg2).init_cache(128, 1024, device="meta")
    specs2 = t_sh.cache_specs(cfg2, cache2, batch_shardable=True, model_size=16)
    assert specs2["k"] == (None, ("pod", "data"), "model", None, None)


@pytest.mark.parametrize("spec, shape, want", [
    (("model", None), (5, 4), (None, None)),            # non-divisible dim drops the axis
    ((("pod", "data"), None), (4, 4), (("data",), None)),
    (("model", "data"), (4, 4), ("model", "data")),
])
def test_dryrun_filter_spec(spec, shape, want):
    """tests/test_substrate.py's three cases, on the same stub mesh, for
    both packages."""
    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": 2})
    assert t_dryrun._filter_spec(spec, mesh, shape) == want
    assert tuple(r_dryrun._filter_spec(P(*spec), mesh, shape)) == _norm(want)


def test_filter_spec_drops_the_outermost_axis_first():
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"),
                           shape={"pod": 2, "data": 16, "model": 16})
    for n, want in ((32, ("pod", "data")), (16, ("data",)), (8, None), (1, None)):
        got = t_dryrun._filter_spec((("pod", "data"),), mesh, (n,))
        assert got == (want,)
        assert tuple(r_dryrun._filter_spec(P(("pod", "data")), mesh, (n,))) == _norm((want,))


@pytest.fixture
def fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def test_to_placements_on_a_device_mesh(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    assert t_sh.to_placements((("pod", "data"), None, "model"), fake_mesh, (8, 3, 4)) == \
        (Shard(0), Shard(0), Shard(2))
    # 'model' does not divide 3: dropped; 6 over (pod, data) = 4 does not
    # divide either, so 'pod' goes first and 'data' stays
    assert t_sh.to_placements((("pod", "data"), "model"), fake_mesh, (6, 3)) == \
        (R, Shard(0), R)
    # axes the mesh lacks are dropped
    assert t_sh.to_placements(("expert", None), fake_mesh, (4, 4)) == (R, R, R)
    with pytest.raises(ValueError, match="mesh order"):
        t_sh.to_placements((("data", "pod"),), fake_mesh, (8,))
