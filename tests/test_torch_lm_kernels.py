"""The port's flash-attention and MoE grouped-matmul plain versions
against the live JAX reference: its Pallas kernels in interpret mode,
its oracles, and its model-path ``chunked_attention``.

Inputs are drawn with NumPy from a seed and handed to both packages
(bf16 inputs are rounded to nearest-even by both).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.common import chunked_attention as j_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.common import chunked_attention  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    """tests/test_kernels.py's tolerances."""
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,hq,hkv,l,d", [
    (1, 4, 4, 128, 64),     # MHA
    (2, 8, 2, 96, 32),      # GQA, ragged length
    (1, 4, 1, 256, 128),    # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (32, 0.0), (0, 50.0)])
def test_plain_flash_matches_pallas_and_oracle(b, hq, hkv, l, d, dtype, window, softcap):
    rng = np.random.default_rng(hash((b, hq, hkv, l, d)) % 2**32)
    jq, tq = _pair(rng, (b, hq, l, d), dtype)
    jk, tk = _pair(rng, (b, hkv, l, d), dtype)
    jv, tv = _pair(rng, (b, hkv, l, d), dtype)
    got = FA.flash_attention(tq, tk, tv, causal=True, window=window, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window, softcap=softcap,
                                  block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    oracle = jref.attention_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                                jv.astype(jnp.float32), causal=True, window=window,
                                softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))
    # the port's own oracle agrees with the reference's
    mine = ref.attention_ref(tq.float(), tk.float(), tv.float(), window=window, softcap=softcap)
    np.testing.assert_allclose(_np(mine), _np(oracle), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Lq, Lk, D, q_offset, kv_offset, kv_valid_len, window, softcap, block)
    (2, 4, 2, 1, 32, 16, 9, 0, 10, 0, 0.0, 1024),      # decode into a padded cache
    (2, 4, 2, 5, 32, 16, 8, 0, 13, 0, 0.0, 1024),      # prefill a chunk at an offset
    (1, 8, 2, 3, 40, 16, 20, 0, 23, 6, 0.0, 16),       # window, several kv blocks
    (2, 4, 4, 4, 24, 8, 30, 10, 24, 0, 20.0, 7),       # kv offset, softcap, ragged block
    (4, 4, 2, 1, 128, 16, 31, 0, 32, 0, 0.0, 1024),    # the serve engine's decode form
])
def test_chunked_attention_with_offsets_matches_reference(case):
    B, Hq, Hkv, Lq, Lk, D, qo, ko, kvl, w, cap, block = case
    rng = np.random.default_rng(sum(case[:6]))
    jq, tq = _pair(rng, (B, Hq, Lq, D), "float32")
    jk, tk = _pair(rng, (B, Hkv, Lk, D), "float32")
    jv, tv = _pair(rng, (B, Hkv, Lk, D), "float32")
    kw = dict(causal=True, window=w, softcap=cap, q_offset=qo, kv_offset=ko,
              kv_valid_len=kvl, block=block)
    want = j_chunked(jq, jk, jv, **kw)
    got = chunked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    if block == 1024:
        # the dispatcher's CPU path is this function
        got2 = ops.flash_attention(tq, tk, tv, causal=True, window=w, softcap=cap,
                                   q_offset=qo, kv_offset=ko, kv_valid_len=kvl)
        assert torch.equal(got2, got)


def test_ring_positions_name_their_roadmap_item():
    """Ring positions (ROADMAP B4) are ported: a negative position masks
    its key, so one valid key among empty slots takes all the weight."""
    q = torch.ones(1, 1, 1, 4)
    k = torch.ones(1, 1, 3, 4)
    v = torch.arange(12.0).reshape(1, 1, 3, 4)
    out = chunked_attention(q, k, v, q_offset=5,
                            kv_positions=torch.tensor([-3, 5, -1], dtype=torch.int64))
    assert torch.equal(out, v[:, :, 1:2])


# ---------------------------------------------------------------------------
# MoE grouped matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,d,f,bc", [(4, 64, 32, 64, 32), (8, 96, 16, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_moe_gmm_matches_pallas_and_oracle(e, c, d, f, bc, dtype):
    rng = np.random.default_rng(e * c + d * f)
    jx, tx = _pair(rng, (e, c, d), dtype)
    jg, tg = _pair(rng, (e, d, f), dtype, 0.1)
    ju, tu = _pair(rng, (e, d, f), dtype, 0.1)
    jd, td = _pair(rng, (e, f, d), dtype, 0.1)
    got = MG.moe_gmm(tx, tg, tu, td)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    pallas = jops.moe_gmm(jx, jg, ju, jd, block_c=bc, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    oracle = jref.moe_gmm_ref(jx, jg, ju, jd)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))
    np.testing.assert_allclose(_np(ref.moe_gmm_ref(tx, tg, tu, td)), _np(oracle),
                               **_tol(dtype))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_dispatch_takes_plain_versions_on_cpu_only():
    q = torch.randn(1, 2, 3, 8)
    k = torch.randn(1, 1, 3, 8)
    n_fa, n_mg = FA.flash_attention.launches, MG.moe_gmm.launches
    assert torch.equal(ops.flash_attention(q, k, k), FA.flash_attention_plain(q, k, k))
    x, w, wd = torch.randn(2, 8, 4), torch.randn(2, 4, 6), torch.randn(2, 6, 4)
    assert torch.equal(ops.moe_gmm(x, w, w, wd), MG.moe_gmm_plain(x, w, w, wd))
    assert (FA.flash_attention.launches, MG.moe_gmm.launches) == (n_fa, n_mg)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.moe_gmm(x.to("meta"), w, w, wd)


@pytest.mark.parametrize("q, k, v, kw, err", [
    (torch.zeros(1, 2, 3, 8, dtype=torch.float64), torch.zeros(1, 1, 3, 8),
     torch.zeros(1, 1, 3, 8), {}, TypeError),
    (torch.zeros(1, 3, 3, 8), torch.zeros(1, 2, 3, 8), torch.zeros(1, 2, 3, 8), {}, ValueError),
    (torch.zeros(1, 2, 3, 512), torch.zeros(1, 1, 3, 512), torch.zeros(1, 1, 3, 512), {},
     ValueError),
    (torch.zeros(1, 2, 3, 8), torch.zeros(1, 1, 8, 3).transpose(2, 3),
     torch.zeros(1, 1, 3, 8), {}, ValueError),
    (torch.zeros(1, 2, 3, 8), torch.zeros(1, 1, 3, 8), torch.zeros(1, 1, 3, 8),
     {"kv_valid_len": 0}, ValueError),
])
def test_flash_cuda_wrapper_validates_before_launch(q, k, v, kw, err):
    args = dict(causal=True, window=0, softcap=0.0, scale=None, q_offset=0, kv_offset=0,
                kv_valid_len=None)
    args.update(kw)
    with pytest.raises(err):
        FA._flash_attention_cuda(q, k, v, **args)


@pytest.mark.parametrize("x, wg, wu, wd, err", [
    (torch.zeros(2, 4, 8, dtype=torch.float16), torch.zeros(2, 8, 6),
     torch.zeros(2, 8, 6), torch.zeros(2, 6, 8), TypeError),
    (torch.zeros(2, 4, 8), torch.zeros(2, 8, 6), torch.zeros(2, 8, 6),
     torch.zeros(2, 8, 6), ValueError),
    (torch.zeros(2, 4, 8), torch.zeros(2, 6, 8).transpose(1, 2), torch.zeros(2, 8, 6),
     torch.zeros(2, 6, 8), ValueError),
    (torch.zeros(0, 4, 8), torch.zeros(0, 8, 6), torch.zeros(0, 8, 6),
     torch.zeros(0, 6, 8), ValueError),
])
def test_moe_cuda_wrapper_validates_before_launch(x, wg, wu, wd, err):
    with pytest.raises(err):
        MG._moe_gmm_cuda(x, wg, wu, wd)
