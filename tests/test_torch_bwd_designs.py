"""The tensor-core designs of the two heaviest backward kernels, on the CPU:
which design each call takes (``bwd_path`` for attention at every head
width of the zoo, ``moe_bwd_path`` for the expert FFN at every MoE shape
of the zoo and a ragged one), the head-group plan of attention's backward
(``flash_bwd_plan``) at the train shapes, the wrappers' checks before
anything is built or launched, the head-group algebra
(``flash_attention_bwd_grouped_plain``) against the plain backward and
against ``jax.vjp`` of the reference at D = 256 on one KV head with a
window, and the bf16 rounding of the MoE backward's hidden gradients
against the plain version's tolerance.  The kernels themselves run on the
card (``tests/test_torch_gpu.py``).  Inputs are drawn with NumPy from a
seed.
"""
import inspect
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models.common import chunked_attention as j_chunked  # noqa: E402
from repro_torch.configs import all_configs, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402

torch.set_num_threads(1)

#: float32 end to end: the two packages sum in other orders
TOL32 = dict(rtol=1e-4, atol=1e-5)
#: the MoE backward's bf16 gate on the card (chip_smoke.py ``TOL_BWD_MAX``):
#: a share of each gradient's largest entry
TOL_BWD_MAX_BF16 = 2e-2

ZOO = all_configs()
#: every attention head width the zoo trains or serves (MLA's query-key width
#: is its ``head_dim``)
ATTN_WIDTHS = sorted({c.head_dim for c in ZOO.values() if c.num_heads})
#: every MoE expert shape of the zoo (d_model, expert d_ff), and a ragged one
MOE_SHAPES = sorted({(c.d_model, c.moe_d_ff) for c in ZOO.values() if c.num_experts}) + [(40, 72)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# which design a call takes
# ---------------------------------------------------------------------------
def test_zoo_widths_are_the_ones_the_designs_cover():
    assert ATTN_WIDTHS == [64, 96, 128, 160, 192, 256]
    assert MOE_SHAPES == [(1024, 512), (5120, 1536), (40, 72)]


@pytest.mark.parametrize("D", ATTN_WIDTHS)
def test_bwd_path_takes_the_tensor_cores_at_every_zoo_width(D):
    assert FA.bwd_path(torch.bfloat16, D) == "mma"
    assert FA.bwd_path(torch.bfloat16, D, aligned=False) == "fma"
    assert FA.bwd_path(torch.float32, D) == "fma"


@pytest.mark.parametrize("D", [36, 100, 252, 264])
def test_bwd_path_keeps_the_cuda_cores_off_the_mma_widths(D):
    assert FA.bwd_path(torch.bfloat16, D) == "fma"


@pytest.mark.parametrize("D, Fd", MOE_SHAPES)
def test_moe_bwd_path_takes_the_tensor_cores_at_zoo_and_ragged_shapes(D, Fd):
    assert MG.moe_bwd_path(torch.bfloat16, D, Fd) == "mma"
    assert MG.moe_bwd_path(torch.bfloat16, D, Fd, aligned=False) == "fma"
    assert MG.moe_bwd_path(torch.float32, D, Fd) == "fma"


@pytest.mark.parametrize("D, Fd", [(36, 72), (40, 70), (1020, 512)])
def test_moe_bwd_path_keeps_the_cuda_cores_off_multiples_of_8(D, Fd):
    assert MG.moe_bwd_path(torch.bfloat16, D, Fd) == "fma"


# ---------------------------------------------------------------------------
# the head-group plan of attention's backward
# ---------------------------------------------------------------------------
#: (arch, head groups) at launch/train.py's traffic, batch 8 x seq 128
TRAIN_GROUPS = [("phi4_mini_3p8b", 1), ("granite_moe_1b", 1), ("recurrentgemma_9b", 8)]


@pytest.mark.parametrize("arch, groups", TRAIN_GROUPS)
def test_flash_bwd_plan_at_the_train_shapes(arch, groups):
    cfg = get_config(arch)
    B, L, hq, hkv, D = 8, 128, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    plan = FA.flash_bwd_plan(torch.bfloat16, B, hq, hkv, L, L, D)
    assert plan.path == "mma"
    assert plan.groups == groups
    assert plan.heads_per_group * plan.groups == hq // hkv
    assert plan.key_tiles == L // plan.block_keys
    assert plan.dkdv_blocks(B, hkv) >= FA.BWD_TARGET_BLOCKS
    assert plan.dq_blocks(B, hq) == B * hq * (L // plan.block_rows)
    scratch = 4 * plan.scratch_floats(B, hkv, L, D)
    assert (scratch == 0) == (groups == 1)
    assert scratch <= 34e6


def test_flash_bwd_plan_takes_the_fewest_groups_that_fill_the_target():
    # recurrentgemma at one sequence of 2048: 32 key tiles, 4 groups of 4 heads
    plan = FA.flash_bwd_plan(torch.bfloat16, 1, 16, 1, 2048, 2048, 256)
    assert (plan.groups, plan.heads_per_group, plan.dkdv_blocks(1, 1)) == (4, 4, 128)
    # a short MQA call cannot reach the target: one head a group
    plan = FA.flash_bwd_plan(torch.bfloat16, 1, 16, 1, 64, 64, 256)
    assert (plan.groups, plan.heads_per_group) == (16, 1)
    # G = 3 has no divisor but 1 and 3
    plan = FA.flash_bwd_plan(torch.bfloat16, 1, 24, 8, 128, 128, 128)
    assert plan.groups == 3 and plan.dkdv_blocks(1, 8) == 48
    # the CUDA-core design takes one group, and its own tiles
    plan = FA.flash_bwd_plan(torch.bfloat16, 8, 16, 1, 128, 128, 128, design="fma")
    assert (plan.path, plan.groups, plan.block_keys, plan.block_rows) == ("fma", 1, 32, 32)
    assert FA.flash_bwd_plan(torch.float32, 8, 16, 1, 128, 128, 256).path == "fma"


def test_flash_bwd_plan_depends_on_the_shape_alone():
    # no SM count or device enters the plan, so the sums are the same on every card
    params = set(inspect.signature(FA.flash_bwd_plan).parameters)
    assert params == {"dtype", "B", "Hq", "Hkv", "Lq", "Lk", "D", "aligned", "design"}
    a = FA.flash_bwd_plan(torch.bfloat16, 8, 16, 1, 128, 128, 256)
    b = FA.flash_bwd_plan(torch.bfloat16, 8, 16, 1, 128, 128, 256)
    assert a == b


# ---------------------------------------------------------------------------
# the wrappers' checks before anything is built or launched
# ---------------------------------------------------------------------------
def _attn(D, dtype=torch.bfloat16, G=2, offset=0):
    B, Hkv, L = 1, 1, 4
    q = torch.zeros(B * G * Hkv * L * D + offset, dtype=dtype)[offset:].view(B, G * Hkv, L, D)
    k = torch.zeros(B, Hkv, L, D, dtype=dtype)
    return q, k, k.clone(), q.clone(), torch.zeros(B, G * Hkv, L), q.clone()


@pytest.mark.parametrize("D", [160, 192, 256])
def test_flash_bwd_checks_take_the_new_widths(D):
    valid, plan = FA._bwd_checked(*_attn(D), None)
    assert valid == 4 and plan.path == "mma"


@pytest.mark.parametrize("D, dtype, design", [
    (264, torch.bfloat16, None),        # past the widest instance
    (252, torch.bfloat16, "mma"),       # not a multiple of 8
    (128, torch.bfloat16, "bogus"),
    (128, torch.float32, "mma"),        # float32 on the tensor cores
])
def test_flash_bwd_checks_refuse_before_launch(D, dtype, design):
    with pytest.raises(ValueError):
        FA._bwd_checked(*_attn(D, dtype), None, design)


def test_flash_bwd_misaligned_operands_leave_the_tensor_cores():
    args = _attn(256, offset=1)           # q starts 2 bytes past a 16-byte boundary
    assert args[0].data_ptr() % 16
    assert FA._bwd_checked(*args, None)[1].path == "fma"
    with pytest.raises(ValueError):
        FA._bwd_checked(*args, None, "mma")


def test_flash_bwd_cuda_wrapper_refuses_a_wide_head_before_building():
    q, k, v, out, lse, dout = _attn(264)
    with pytest.raises(ValueError):
        FA._flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True, window=0,
                                     softcap=0.0, scale=None, q_offset=0, kv_offset=0,
                                     kv_valid_len=None)


def _moe(E, C, D, Fd, dtype=torch.bfloat16):
    return (torch.zeros(E, C, D, dtype=dtype), torch.zeros(E, D, Fd, dtype=dtype),
            torch.zeros(E, D, Fd, dtype=dtype), torch.zeros(E, Fd, D, dtype=dtype),
            torch.zeros(E, C, D, dtype=dtype))


@pytest.mark.parametrize("shape, dtype, path", [
    ((3, 70, 40, 72), torch.bfloat16, "mma"),   # ragged C, D and F multiples of 8
    ((2, 8, 5120, 1536), torch.bfloat16, "mma"),
    ((3, 70, 36, 72), torch.bfloat16, "fma"),
    ((3, 70, 40, 72), torch.float32, "fma"),
])
def test_moe_bwd_checks_pick_the_design(shape, dtype, path):
    assert MG._bwd_checked(*_moe(*shape, dtype=dtype)) == (*shape, path)


@pytest.mark.parametrize("dtype, design, dy_shape", [
    (torch.float32, "mma", None),      # float32 on the tensor cores
    (torch.bfloat16, "bogus", None),
    (torch.bfloat16, None, (3, 70, 48)),
])
def test_moe_bwd_cuda_wrapper_refuses_before_building(dtype, design, dy_shape):
    x, wg, wu, wd, dy = _moe(3, 70, 40, 72, dtype=dtype)
    if dy_shape:
        dy = torch.zeros(dy_shape, dtype=dtype)
    with pytest.raises(ValueError):
        MG._moe_gmm_bwd_cuda(x, wg, wu, wd, dy, design=design)


# ---------------------------------------------------------------------------
# the head-group algebra
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16])
def test_grouped_backward_equals_the_plain_backward(groups):
    rng = np.random.default_rng(groups)
    B, Hq, Hkv, L, D = 2, 16, 1, 24, 32
    q, dout = (torch.tensor(rng.standard_normal((B, Hq, L, D)), dtype=torch.float32)
               for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, Hkv, L, D)), dtype=torch.float32)
            for _ in range(2))
    kw = dict(causal=True, window=7)
    out, lse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    got = FA.flash_attention_bwd_grouped_plain(q, k, v, out, lse, dout, groups, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd_grouped_plain(q, k, v, out, lse, dout, 3, **kw)


def test_flash_bwd_d256_mqa_window_matches_reference_vjp():
    """D = 256, G = 16 query heads on one KV head, a window, offsets and a
    ragged key block: the plain backward and the head-group algebra at
    recurrentgemma's train plan (8 groups) against ``jax.vjp`` of the
    reference's ``chunked_attention``, float32."""
    B, Hq, Hkv, Lq, Lk, D, qo, ko, block, window = 1, 16, 1, 12, 20, 256, 9, 1, 8, 6
    rng = np.random.default_rng(256)
    q = rng.standard_normal((B, Hq, Lq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Lq, D)).astype(np.float32)
    qpos = qo + np.arange(Lq)[:, None]
    kpos = ko + np.arange(Lk)[None, :]
    rows = ((kpos <= qpos) & (kpos > qpos - window)).any(axis=1)
    assert rows.all()
    kw = dict(causal=True, window=window, softcap=0.0, q_offset=qo, kv_offset=ko)
    jout, vjp = jax.vjp(lambda a, b, c: j_chunked(a, b, c, block=block, **kw),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    out, lse = FA.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL32)
    plan = FA.flash_bwd_plan(torch.bfloat16, 8, Hq, Hkv, 128, 128, D)
    assert plan.groups == 8
    for got in (FA.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, block=block, **kw),
                FA.flash_attention_bwd_grouped_plain(tq, tk, tv, out, lse, tdo, plan.groups,
                                                     block=block, **kw)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(_np(g), _np(w), **TOL32, err_msg=name)


# ---------------------------------------------------------------------------
# the MoE backward's bf16 hidden gradients
# ---------------------------------------------------------------------------
def _moe_bwd_bf16_hidden(x, wg, wu, wd, dy):
    """``moe_gmm_bwd_plain`` with dh and du rounded once to bf16 before the
    dx and dW products, as the tensor-core design stores them."""
    xf, wgf, wuf, wdf, dyf = (t.float() for t in (x, wg, wu, wd, dy))
    h, u = torch.bmm(xf, wgf), torch.bmm(xf, wuf)
    g = torch.bmm(dyf, wdf.transpose(1, 2))
    sig = torch.sigmoid(h)
    a = (F.silu(h) * u).to(torch.bfloat16).float()
    dh = (g * u * (sig * (1 + h * (1 - sig)))).to(torch.bfloat16).float()
    du = (g * F.silu(h)).to(torch.bfloat16).float()
    dx = torch.bmm(dh, wgf.transpose(1, 2)) + torch.bmm(du, wuf.transpose(1, 2))
    xt = xf.transpose(1, 2)
    return tuple(t.to(torch.bfloat16) for t in (dx, torch.bmm(xt, dh), torch.bmm(xt, du),
                                                torch.bmm(a.transpose(1, 2), dyf)))


@pytest.mark.parametrize("E, C, D, Fd", [(2, 64, 256, 128), (3, 8, 128, 64), (3, 70, 40, 72)])
def test_bf16_hidden_gradients_stay_within_the_card_gate(E, C, D, Fd):
    rng = np.random.default_rng(E * C + D)

    def t(shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape), dtype=torch.float32).to(
            torch.bfloat16)

    x, dy = t((E, C, D)), t((E, C, D))
    wg, wu = t((E, D, Fd), D ** -0.5), t((E, D, Fd), D ** -0.5)
    wd = t((E, Fd, D), Fd ** -0.5)
    want = MG.moe_gmm_bwd_plain(x, wg, wu, wd, dy)
    for name, g, w in zip(("dx", "dwg", "dwu", "dwd"), _moe_bwd_bf16_hidden(x, wg, wu, wd, dy),
                          want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= TOL_BWD_MAX_BF16 * float(w.float().abs().max()), name
