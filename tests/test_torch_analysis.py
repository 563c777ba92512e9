"""The port's ``analysis/`` against the reference's, on the CPU.

The HLO-text parsers (``hlo``, ``costs``, ``buffers``) are the
reference's verbatim and must give equal output on the same texts: the
synthetic modules of ``tests/test_property.py`` (collectives, a while loop
with its trip count) and modules that JAX compiles here (a scanned matmul,
a small sharded function).  ``model_flops`` is equal for every arch and
shape kind; ``RooflineTerms`` reads given counts on the H100 constants.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.analysis import buffers as r_buffers  # noqa: E402
from repro.analysis import costs as r_costs  # noqa: E402
from repro.analysis import hlo as r_hlo  # noqa: E402
from repro.analysis import roofline as r_roof  # noqa: E402
from repro.configs import ARCHS as R_ARCHS  # noqa: E402
from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import get_config as r_config  # noqa: E402
from repro_torch.analysis import buffers as t_buffers  # noqa: E402
from repro_torch.analysis import costs as t_costs  # noqa: E402
from repro_torch.analysis import hlo as t_hlo  # noqa: E402
from repro_torch.analysis import roofline as t_roof  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402


def _synthetic_collectives(n, dt, a, b):
    lines = ["HloModule m", "ENTRY %main {", f"  %p0 = {dt}[{a},{b}]{{1,0}} parameter(0)"]
    for i in range(n):
        lines.append(f"  %all-reduce.{i} = {dt}[{a},{b}]{{1,0}} all-reduce(%p0), "
                     "replica_groups={}, to_apply=%add")
    lines.append(f"  %ag = {dt}[{2 * a},{b}]{{1,0}} all-gather(%p0), dimensions={{0}}")
    lines.append(f"  ROOT %t = ({dt}[{a},{b}]{{1,0}}) tuple(%all-reduce.0)")
    lines.append("}")
    return "\n".join(lines)


WHILE_TEXT = """HloModule loop

%body (p: (s32[], f32[64,64])) -> (s32[], f32[64,64]) {
  %p = (s32[], f32[64,64]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[64,64]{1,0} get-tuple-element(%p), index=1
  %d = f32[64,64]{1,0} dot(%x, %x), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[64,64]{1,0} all-reduce(%d), replica_groups={}, to_apply=%add
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[64,64]{1,0}) tuple(%i2, %ar)
}

%cond (p: (s32[], f32[64,64])) -> pred[] {
  %p = (s32[], f32[64,64]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(12)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

ENTRY %main (a: f32[64,64]) -> f32[64,64] {
  %a = f32[64,64]{1,0} parameter(0)
  %z = s32[] constant(0)
  %init = (s32[], f32[64,64]{1,0}) tuple(%z, %a)
  %w = (s32[], f32[64,64]{1,0}) while(%init), condition=%cond, body=%body
  ROOT %out = f32[64,64]{1,0} get-tuple-element(%w), index=1
}
"""


def _scanned_matmul_text():
    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, ws)[0]

    x = jnp.ones((32, 64), jnp.float32)
    ws = jnp.ones((10, 64, 64), jnp.float32)
    return jax.jit(f).lower(x, ws).compile().as_text()


def _sharded_text():
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax.make_mesh((1,), ("data",))
    sh = NamedSharding(mesh, P("data", None))

    def f(x, w):
        return jnp.sum(jnp.einsum("bd,df->bf", x, w) ** 2, axis=0)

    x = jnp.ones((16, 32), jnp.bfloat16)
    w = jnp.ones((32, 48), jnp.bfloat16)
    return jax.jit(f, in_shardings=(sh, None)).lower(x, w).compile().as_text()


TEXTS = {
    "allreduce_f32": lambda: _synthetic_collectives(3, "f32", 8, 16),
    "allreduce_bf16": lambda: _synthetic_collectives(1, "bf16", 64, 128),
    "while_loop": lambda: WHILE_TEXT,
    "scanned_matmul": _scanned_matmul_text,
    "sharded": _sharded_text,
}


@pytest.fixture(scope="module")
def texts():
    return {k: fn() for k, fn in TEXTS.items()}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_hlo_parsers_equal_reference(texts, name):
    text = texts[name]
    assert t_hlo.parse_hlo_collectives(text) == r_hlo.parse_hlo_collectives(text)
    assert t_hlo.collective_bytes(text) == r_hlo.collective_bytes(text)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_weighted_costs_equal_reference(texts, name):
    text = texts[name]
    got = t_costs.weighted_costs(text)
    assert got == r_costs.weighted_costs(text)
    if name == "while_loop":   # 12 trips of a 64^3 dot
        assert got["flops"] == 12 * 2 * 64 ** 3


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_buffer_diagnosis_equal_reference(texts, name):
    text = texts[name]
    assert t_buffers.top_buffers(text, min_bytes=0) == r_buffers.top_buffers(text, min_bytes=0)
    assert t_buffers.collective_census(text) == r_buffers.collective_census(text)


def test_parsers_are_the_reference_verbatim_but_imports():
    import inspect

    for t, r in ((t_hlo, r_hlo), (t_costs, r_costs), (t_buffers, r_buffers)):
        assert inspect.getsource(t) == inspect.getsource(r)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    assert tuple(ARCHS) == tuple(R_ARCHS) and set(SHAPES) == set(R_SHAPES)
    for name, shape in SHAPES.items():
        tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
        assert t_roof.model_flops(get_config(arch), shape.kind, tokens) == \
            r_roof.model_flops(r_config(arch), R_SHAPES[name].kind, tokens)


@pytest.mark.parametrize("counts, dominant", [
    (dict(flops=4.2e15, bytes=1e12, coll=5e9), "compute"),
    (dict(flops=1e12, bytes=9e12, coll=5e9), "memory"),
    (dict(flops=1e12, bytes=1e11, coll=2e12), "collective"),
])
def test_roofline_terms_on_h100_constants(counts, dominant):
    hw = t_roof.HW
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    shape = SHAPES["train_4k"]
    cfg = get_config("granite_moe_1b")
    coll = {"all-gather": counts["coll"] / 2, "all-reduce": counts["coll"] / 2,
            "reduce-scatter": 0.0, "all-to-all": 0.0, "collective-permute": 0.0,
            "total": counts["coll"], "count": 7.0}
    terms = t_roof.roofline_from_trace(
        "granite_moe_1b", shape, "pod16x16", 256,
        {"flops": counts["flops"], "bytes": counts["bytes"], "collective": coll, "ops": 11},
        cfg)
    assert terms.compute_s == counts["flops"] / 989e12
    assert terms.memory_s == counts["bytes"] / 3.35e12
    assert terms.collective_s == counts["coll"] / 450e9
    assert terms.dominant == dominant
    assert terms.bound_s == max(terms.compute_s, terms.memory_s, terms.collective_s)
    mf = t_roof.model_flops(cfg, "train", shape.tokens)
    assert terms.model_flops_global == mf
    np.testing.assert_allclose(terms.useful_flops_ratio, mf / (counts["flops"] * 256))
    np.testing.assert_allclose(terms.roofline_fraction, mf / (256 * 989e12) / terms.bound_s)
    assert set(terms.collective_breakdown) == {"all-gather", "all-reduce", "reduce-scatter",
                                               "all-to-all", "collective-permute"}
    ref = r_roof.RooflineTerms("a", "s", "m", 1, 1.0, 1.0, 1.0, {})
    assert set(terms.to_dict()) == set(ref.to_dict())
