"""The redesigned backwards of the SSD intra-chunk part and the RG-LRU scan,
on the CPU: which design each call takes (``ssd_bwd_path`` / ``ssd_bwd_plan``
at every SSD shape the zoo trains or serves and at the ragged edges,
``rglru_bwd_path`` at recurrentgemma's width), the wrappers' checks before
anything is built or launched, a plain emulation of the SSD tensor-core
design's roundings and of its head-group order for dCB, held to the plain
backward and to ``jax.vjp`` of the reference's model-level chunked scan
within the card's bf16 gate, and a plain emulation of the RG-LRU design's
chunk-lane decomposition held to the plain backward and ``jax.vjp`` of the
reference scan in float32.  The kernels themselves run on the card
(``tests/test_torch_gpu.py``).  Inputs are drawn with NumPy from a seed.
"""
import inspect
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402

torch.set_num_threads(1)

#: float32 end to end: the two packages sum in other orders
TOL32 = dict(rtol=1e-4, atol=1e-5)
#: the backwards' bf16 gate on the card (chip_smoke.py ``TOL_BWD_MAX``): a
#: share of each gradient's largest entry
TOL_BWD_MAX_BF16 = 2e-2
BF16 = torch.bfloat16

ZOO = all_configs()
#: every SSD shape (P, N) of the zoo, at the chunks it trains (seq 128 in one
#: chunk, seq 1024 in chunks of 256) and serves (the 16-token prefill)
SSD_ZOO = sorted({(c.ssm_head_dim, c.ssm_state) for c in ZOO.values() if c.family == "ssm"})
#: the widths of the zoo's RG-LRU layers
LRU_WIDTHS = sorted({c.lru_width or c.d_model for c in ZOO.values() if c.family == "hybrid"})


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# which design a call takes
# ---------------------------------------------------------------------------
def test_zoo_shapes_are_the_ones_the_designs_cover():
    assert SSD_ZOO == [(64, 128)]
    assert LRU_WIDTHS == [4096]


@pytest.mark.parametrize("C", [16, 128, 256])
@pytest.mark.parametrize("P, N", SSD_ZOO)
def test_ssd_bwd_path_takes_the_tensor_cores_at_every_zoo_shape(P, N, C):
    assert SSD.ssd_bwd_path(BF16, C, P, N) == "mma"
    assert SSD.ssd_bwd_path(torch.float32, C, P, N) == "fma"


@pytest.mark.parametrize("C, P, N, path", [
    (40, 8, 24, "mma"),       # C, N no multiple of 16, the narrowest head
    (256, 128, 256, "mma"),   # the widest: 223 KB of shared memory
    (13, 16, 20, "mma"),      # a chunk shorter than a tile
    (32, 4, 16, "fma"),       # P < 8: no n8 tile
    (64, 48, 32, "fma"),      # P no power of two
])
def test_ssd_bwd_path_at_the_edges(C, P, N, path):
    assert SSD.ssd_bwd_path(BF16, C, P, N) == path
    assert SSD.ssd_bwd_smem_bytes(C, P, N) <= SSD.SMEM_MAX or path == "fma"
    # P = 128 with contrib's gradient stays on the CUDA cores (registers);
    # below it the head's dcontrib fits beside the head region
    assert SSD.ssd_bwd_path(BF16, C, P, N, contrib=True) == (path if P < 128 else "fma")
    if path == "mma" and P < 128:
        assert SSD.ssd_bwd_smem_bytes(C, P, N, True) <= SSD.SMEM_MAX


#: (BC, C, head groups, bands, two blocks an SM) at mamba2-2.7b's train
#: shapes: batch 8 x one chunk of 128, batch 2 x four chunks of 256
TRAIN_PLANS = [(8, 128, 33, 1, True), (8, 256, 8, 2, False)]


@pytest.mark.parametrize("BC, C, groups, bands, two", TRAIN_PLANS)
def test_ssd_bwd_plan_at_the_train_shapes(BC, C, groups, bands, two):
    cfg = ZOO["mamba2_2p7b"]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    plan = SSD.ssd_bwd_plan(BF16, BC, C, H, P, N)
    assert (plan.path, plan.groups, plan.bands) == ("mma", groups, bands)
    assert (2 * (plan.smem + 1024) <= 228 * 1024) == two
    per_sm = 2 if two else 1
    assert BC * bands * groups <= SSD.SSD_BWD_TARGET_BLOCKS * per_sm
    assert BC * bands * (groups + 1) > SSD.SSD_BWD_TARGET_BLOCKS * per_sm
    # dcontrib's head takes shared memory beside the head region
    with_c = SSD.ssd_bwd_plan(BF16, BC, C, H, P, N, None, True)
    assert plan.smem <= with_c.smem <= SSD.SMEM_MAX
    assert SSD.ssd_bwd_plan(torch.float32, BC, C, H, P, N).path == "fma"


def test_ssd_bwd_plan_depends_on_the_shape_alone():
    # no SM count or device enters the plan, so the sums are the same on every card
    params = set(inspect.signature(SSD.ssd_bwd_plan).parameters)
    assert params == {"dtype", "BC", "C", "H", "P", "N", "design", "contrib"}
    assert SSD.ssd_bwd_plan(BF16, 8, 128, 80, 64, 128) == SSD.ssd_bwd_plan(BF16, 8, 128, 80,
                                                                          64, 128)
    assert SSD.ssd_bwd_plan(BF16, 8, 128, 80, 64, 128, "fma").path == "fma"


@pytest.mark.parametrize("W", LRU_WIDTHS + [512])
def test_rglru_bwd_path_takes_the_vectorised_lanes(W):
    assert RG.rglru_bwd_path(BF16, W) == "vec"
    assert RG.rglru_bwd_path(BF16, W, aligned=False) == "scalar"
    assert RG.rglru_bwd_path(torch.float32, W) == "scalar"


@pytest.mark.parametrize("W", [100, 4092, 6])
def test_rglru_bwd_path_keeps_other_widths_on_the_first_design(W):
    assert RG.rglru_bwd_path(BF16, W) == "scalar"


def _unit_segments(band, nt):
    """The main kernel's split of a band's tile pairs over its 8 warps
    (``unit_segment`` in csrc/ssd_intra_chunk_bwd.cu): warps w and w + 4 share
    the long s-tile of slot 2w and the short one of slot 2w + 1; warp w takes
    the long tile's first ceil((n_long + n_short) / 2) pairs, warp w + 4 the
    short tile and the long tile's rest.  Returns warp -> [(s-tile, t-tiles)]."""
    def tile(k):
        return nt - 1 - (k >> 1) if k & 1 else k >> 1

    out = {}
    for w in range(8):
        sl = band * 8 + 2 * (w & 3)
        nl = nt - tile(sl) if sl < nt else 0
        ns = nt - tile(sl + 1) if sl + 1 < nt else 0
        al = min(nl, (nl + ns + 1) // 2)
        segs = []
        if w < 4:
            if al:
                segs.append((tile(sl), range(tile(sl), tile(sl) + al)))
        else:
            if ns:
                segs.append((tile(sl + 1), range(tile(sl + 1), nt)))
            if nl - al:
                segs.append((tile(sl), range(tile(sl) + al, nt)))
        out[w] = segs
    return out


@pytest.mark.parametrize("nt", list(range(1, 17)))
def test_main_kernel_units_cover_every_pair_once_and_balance_the_warps(nt):
    """Every causal (s-tile, t-tile) pair of the chunk lies in one warp's
    segment of one band, and no warp holds more than ceil((nt + 1) / 2)
    pairs (the s-tile-per-warp design's busiest warp held nt)."""
    seen = []
    for band in range(-(-nt // 8)):
        segs = _unit_segments(band, nt)
        for w, ss in segs.items():
            assert len(ss) <= 2
            assert sum(len(r) for _, r in ss) <= -(-(nt + 1) // 2)
            seen += [(s, t) for s, r in ss for t in r]
    assert sorted(seen) == [(s, t) for s in range(nt) for t in range(s, nt)]


# ---------------------------------------------------------------------------
# the wrappers' checks before anything is built or launched
# ---------------------------------------------------------------------------
def _ssd(dtype=BF16, P=16, bad=None):
    B, nb, C, H, N = 1, 2, 8, 3, 16
    x = torch.zeros(B, nb, C, H, P, dtype=dtype)
    dt = torch.zeros(B, nb, C, H)
    A = torch.zeros(H)
    Bm = torch.zeros(B, nb, C, N, dtype=dtype)
    Cm = torch.zeros(B, nb, C, N, dtype=dtype)
    dy = torch.zeros(B, nb, C, H, P)
    args = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, dy=dy)
    if bad:
        args.update(bad)
    return args


@pytest.mark.parametrize("kw, design, exc", [
    ({}, "bogus", ValueError),
    ({"dtype": torch.float32}, "mma", ValueError),     # float32 on the tensor cores
    ({"P": 4}, "mma", ValueError),                     # P < 8
    ({"P": 128, "bad": {"dcontrib": torch.zeros(1, 2, 3, 128, 16)}}, "mma", ValueError),
    ({"bad": {"Cm": torch.zeros(1, 2, 8, 16)}}, None, TypeError),       # Cm float32
    ({"bad": {"dt": torch.zeros(1, 2, 8, 3, dtype=BF16)}}, None, TypeError),
    ({"bad": {"dy": torch.zeros(1, 2, 8, 3, 8)}}, None, ValueError),     # dy's shape
    ({"bad": {"A": torch.zeros(4)}}, None, ValueError),
])
def test_ssd_bwd_cuda_wrapper_refuses_before_building(kw, design, exc):
    args = _ssd(**kw)
    with pytest.raises(exc):
        SSD._ssd_intra_chunk_bwd_cuda(**args, design=design)


def _rg(dtype=BF16, W=16, bad=None):
    B, L = 2, 5
    x = torch.zeros(B, L, W, dtype=dtype)
    args = dict(x=x, r=x.clone(), i=x.clone(), lam=torch.zeros(W),
                h0=torch.zeros(B, W, dtype=dtype), out=torch.zeros(B, L, W),
                dh=torch.zeros(B, L, W))
    if bad:
        args.update(bad)
    return args


@pytest.mark.parametrize("kw, design, exc", [
    ({}, "bogus", ValueError),
    ({"dtype": torch.float32}, "vec", ValueError),     # float32 on the bf16 lanes
    ({"W": 12}, "vec", ValueError),                    # W no multiple of 8
    ({"bad": {"r": torch.zeros(2, 5, 16)}}, None, TypeError),
    ({"bad": {"dh": torch.zeros(2, 4, 16)}}, None, ValueError),
    ({"bad": {"lam": torch.zeros(8)}}, None, ValueError),
])
def test_rglru_bwd_cuda_wrapper_refuses_before_building(kw, design, exc):
    args = _rg(**kw)
    with pytest.raises(exc):
        RG._rglru_scan_bwd_cuda(**args, design=design)


# ---------------------------------------------------------------------------
# the SSD tensor-core design's roundings, emulated
# ---------------------------------------------------------------------------
def _bf(t):
    return t.to(BF16).double()


def _hi_lo(t):
    """t's float32 values as the bf16 pair hi + lo the kernel multiplies."""
    t = t.float()
    hi = t.to(BF16).float()
    return hi.double() + (t - hi).to(BF16).double()


def ssd_bwd_mma_emulated(x, dt, A, Bm, Cm, dy=None, dcontrib=None, ddecay=None, groups=1,
                         single=False):
    """The tensor-core backward's arithmetic in float64 but for its operand
    roundings: dy, dcontrib and coef x rounded once to bf16, W^T and dCB split
    hi + lo (``single``: every float32 operand rounded once), C.B^T exact in
    float32, each head's dCB term summed in float32 and the groups' sums
    added in group order (``ssd_bwd_plan``'s head groups).  Returns ``(dx,
    ddt, dA, dB, dC)`` as the kernel stores them."""
    split = _bf if single else _hi_lo
    c = x.shape[2]
    H = x.shape[3]
    xf, dtf, Af, Bf, Cf = (t.double() for t in (x, dt, A, Bm, Cm))
    ack = SSD.chunk_cumsum(dt, A).double()                 # float64 sum, rounded once
    seg = ack[:, :, :, None, :] - ack[:, :, None, :, :]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool))
    lw = torch.exp(seg.float().masked_fill(~causal[None, None, :, :, None],
                                           -float("inf"))).double()
    cb = torch.einsum("bktn,bksn->bkts", Cf, Bf).float().double()
    last = ack[:, :, -1:, :]
    e_last = torch.exp((last - ack).float()).double()
    coef = (dtf * e_last).float().double()
    dx = torch.zeros_like(xf)
    d_ack = torch.zeros_like(ack)
    ddt = torch.zeros_like(ack)
    dcb = torch.zeros_like(cb)
    if dy is not None:
        dyb = _bf(dy)
        w = (cb[..., None] * lw * dtf[:, :, None, :, :]).float()
        dx = dx + torch.einsum("bktsh,bkthp->bkshp", split(w), dyb)
        dw = torch.einsum("bkthp,bkshp->bktsh", dyb, xf).float().double()
        q = dw * cb[..., None] * lw
        qd = q * dtf[:, :, None, :, :]
        d_ack = d_ack + qd.sum(dim=3) - qd.sum(dim=2)
        ddt = ddt + q.sum(dim=2)
        term = (dw * lw * dtf[:, :, None, :, :]).float()  # (B, nb, t, s, H)
        for g in range(groups):                            # group sums, then in group order
            lo, hi = g * H // groups, (g + 1) * H // groups
            dcb = dcb + term[..., lo:hi].sum(dim=-1).float().double()
        dcb = dcb.float()
    dB = torch.einsum("bkts,bktn->bksn", split(dcb), Cf) if dy is not None else torch.zeros_like(Bf)
    dC = torch.einsum("bkts,bksn->bktn", split(dcb), Bf) if dy is not None else torch.zeros_like(Cf)
    if dcontrib is not None:
        dcb_ = _bf(dcontrib)
        g_ = torch.einsum("bksn,bkhpn->bkshp", Bf, dcb_).float().double()
        dx = dx + coef[..., None] * g_
        dcoef = (xf * g_).sum(dim=-1)
        dB = dB + torch.einsum("bkshp,bkhpn->bksn", _bf((coef[..., None] * xf).float()), dcb_)
        d_ack = d_ack - dcoef * coef
        d_ack[:, :, -1] += (dcoef * coef).sum(dim=2)
        ddt = ddt + dcoef * e_last
    if ddecay is not None:
        d_ack[:, :, -1] += ddecay.double() * torch.exp(last[:, :, 0])
    dz = torch.flip(torch.cumsum(torch.flip(d_ack, (2,)), dim=2), (2,))
    ddt = ddt + dz * Af
    dA = (dz * dtf).sum(dim=(0, 1, 2))
    return dx.to(x.dtype), ddt.float(), dA.float(), dB.to(Bm.dtype), dC.to(Cm.dtype)


def _ssd_inputs(B, L, H, P, N, chunk, seed, every=True):
    rng = np.random.default_rng(seed)
    nb = L // chunk

    def bf(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32).to(BF16)

    x, Bm, Cm = bf((B, nb, chunk, H, P)), bf((B, nb, chunk, N)), bf((B, nb, chunk, N))
    dt = torch.nn.functional.softplus(torch.tensor(rng.standard_normal((B, nb, chunk, H)),
                                                   dtype=torch.float32))
    A = -torch.exp(0.3 * torch.tensor(rng.standard_normal(H), dtype=torch.float32))
    grads = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for s in ((B, nb, chunk, H, P), (B, nb, H, P, N), (B, nb, H))]
    if not every:
        grads[1:] = [None, None]
    return (x, dt, A, Bm, Cm), grads


#: (B, L, H, P, N, chunk, every gradient): mamba2's chunk of 256 at 2 chunks
#: (all three gradients), one chunk of 128 (dy alone, the train step's), and
#: the ragged tile edges
EMU_CASES = [(1, 512, 6, 16, 32, 256, True), (2, 128, 5, 64, 128, 128, False),
             (2, 80, 3, 8, 24, 40, True)]


@pytest.mark.parametrize("B, L, H, P, N, chunk, every", EMU_CASES)
def test_ssd_mma_roundings_within_the_card_gate(B, L, H, P, N, chunk, every):
    args, grads = _ssd_inputs(B, L, H, P, N, chunk, seed=L + H, every=every)
    BC = B * (L // chunk)
    groups = SSD.ssd_bwd_plan(BF16, BC, chunk, H, P, N, None, every).groups
    want = SSD.ssd_intra_chunk_bwd_plain(*args, *grads)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"),
                          ssd_bwd_mma_emulated(*args, *grads, groups=groups), want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g, w) <= TOL_BWD_MAX_BF16, name


def test_ssd_single_roundings_also_hold_the_gate():
    """Unlike the forward's W at chunk 256 (tests/test_torch_ssm.py), one bf16
    rounding of every float32 operand would still hold the backward's gate
    (a share of each gradient's largest entry; the largest errors are the
    outputs' own bf16 roundings): the hi + lo splits of W^T and dCB are
    headroom, and they cost ~2 % of the device time (scripts/bwd_variants.py
    ``w_single``)."""
    args, grads = _ssd_inputs(1, 512, 6, 16, 32, 256, seed=7)
    want = SSD.ssd_intra_chunk_bwd_plain(*args, *grads)
    split = ssd_bwd_mma_emulated(*args, *grads, groups=3)
    single = ssd_bwd_mma_emulated(*args, *grads, groups=3, single=True)
    for name, s, o, w in zip(("dx", "ddt", "dA", "dB", "dC"), split, single, want):
        assert _rel(o, w) <= TOL_BWD_MAX_BF16, name
        assert _rel(s, w) <= TOL_BWD_MAX_BF16, name


@pytest.mark.parametrize("groups", [1, 2, 3, 6])
def test_ssd_head_group_order_of_dcb(groups):
    """dCB's head sums in group order stay within float32 rounding of one sum
    over every head: the plan's group count moves no gradient past it."""
    args, grads = _ssd_inputs(1, 256, 6, 16, 32, 128, seed=groups)
    one = ssd_bwd_mma_emulated(*args, *grads, groups=1)
    got = ssd_bwd_mma_emulated(*args, *grads, groups=groups)
    for name, g, o in zip(("dx", "ddt", "dA", "dB", "dC"), got, one):
        assert _rel(g, o) <= 1e-2 * TOL_BWD_MAX_BF16 or torch.equal(g, o), name


def test_ssd_mma_emulation_in_the_op_matches_reference_vjp(monkeypatch):
    """The emulation put in place of the intra-chunk backward under
    ``ops.ssd_chunked``'s autograd, at two chunks of 256, against ``jax.vjp``
    of the reference's model-level chunked scan on the same bf16-valued
    inputs, within the card's gate."""
    B, L, H, P, N, chunk = 1, 512, 4, 16, 32, 256
    rng = np.random.default_rng(512)

    def bfv(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32).to(BF16).float()

    x, Bm, Cm = bfv((B, L, H, P)), bfv((B, L, 1, N)), bfv((B, L, 1, N))
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    ins = [_np(x), dt, A, _np(Bm), _np(Cm)]
    (_, _), vjp = jax.vjp(lambda *a: j_ssd_chunked(*a, chunk=chunk),
                          *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    groups = SSD.ssd_bwd_plan(BF16, B * L // chunk, chunk, H, P, N, None, True).groups

    def emulated(x, dt, A, Bm, Cm, dy=None, dcontrib=None, ddecay=None):
        return ssd_bwd_mma_emulated(x.to(BF16), dt, A, Bm.to(BF16), Cm.to(BF16), dy, dcontrib,
                                    ddecay, groups=groups)

    monkeypatch.setattr(SSD, "ssd_intra_chunk_bwd", emulated)
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    y, st = ops.ssd_chunked(*leaves, chunk=chunk)
    ((y * torch.tensor(dy)).sum() + (st * torch.tensor(ds)).sum()).backward()
    for name, leaf, w in zip(("dx", "ddt", "dA", "dB", "dC"), leaves, want):
        w = torch.tensor(np.asarray(w))
        assert _rel(leaf.grad, w) <= TOL_BWD_MAX_BF16, name


# ---------------------------------------------------------------------------
# the RG-LRU design's chunk lanes, emulated
# ---------------------------------------------------------------------------
def rglru_bwd_lanes(x, r, i, lam, h0, out, dh, dh_t=None, lanes=32):
    """The vectorised design's decomposition in float32: L cut into
    ``lanes`` chunks of ceil(L / lanes) steps; pass 1 runs each chunk back
    from g = 0 (its end value, the product of its decays past its first
    step, its first decay); the chunk maps are composed from the last chunk
    to the first; pass 3 replays each chunk from the g entering it; dlam's
    terms are summed per lane, then over the lanes in order, then over the
    batch in order."""
    x, r, i, h0, out, dh = (t.float() for t in (x, r, i, h0, out, dh))
    B, L, W = x.shape
    lv = lam.float()
    ncs = -8.0 * (torch.clamp(lv, min=0) + torch.log1p(torch.exp(-torch.abs(lv))))
    sr, si = torch.sigmoid(r), torch.sigmoid(i)
    log_a = ncs * sr
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    z = 1.0 - e2
    beta = torch.sqrt(torch.clamp(z, min=1e-12))
    g_out = dh.clone()
    if dh_t is not None:
        g_out[:, -1] += dh_t.float()
    tc = -(-L // lanes)
    bounds = [(min(L, k * tc), min(L, k * tc + tc)) for k in range(lanes)]
    ends, prods, firsts = [], [], []
    for t0, t1 in bounds:                                   # pass 1
        g = torch.zeros(B, W)
        prod = torch.ones(B, W)
        a_next = torch.zeros(B, W)
        for t in range(t1 - 1, t0 - 1, -1):
            g = a_next * g + g_out[:, t]
            if t > t0:
                prod = prod * a[:, t]
            a_next = a[:, t]
        ends.append(g)
        prods.append(prod)
        firsts.append(a_next if t0 < t1 else torch.zeros(B, W))
    entering = [None] * lanes                               # the carry, last to first
    carry = torch.zeros(B, W)
    for k in range(lanes - 1, -1, -1):
        entering[k] = carry
        p = prods[k] * (firsts[k + 1] if k + 1 < lanes else torch.zeros(B, W))
        carry = p * carry + ends[k]
    dx, dr, di = (torch.zeros(B, L, W) for _ in range(3))
    dh0 = torch.zeros(B, W)
    lane_lam = []
    for k, (t0, t1) in enumerate(bounds):                   # pass 3
        g = entering[k]
        a_next = firsts[k + 1] if k + 1 < lanes else torch.zeros(B, W)
        acc = torch.zeros(B, W)
        for t in range(t1 - 1, t0 - 1, -1):
            g = a_next * g + g_out[:, t]
            h_prev = out[:, t - 1] if t > 0 else h0
            dlog_a = g * h_prev * a[:, t]
            dlog_a = torch.where(z[:, t] > 1e-12,
                                 dlog_a - g * si[:, t] * x[:, t] * e2[:, t] / beta[:, t], dlog_a)
            dx[:, t] = g * beta[:, t] * si[:, t]
            di[:, t] = g * beta[:, t] * x[:, t] * si[:, t] * (1 - si[:, t])
            dr[:, t] = dlog_a * ncs * sr[:, t] * (1 - sr[:, t])
            acc = acc + dlog_a * sr[:, t]
            if t == 0:
                dh0 = a[:, 0] * g
            a_next = a[:, t]
        lane_lam.append(acc)
    part = torch.zeros(B, W)
    for acc in lane_lam:                                    # lanes in order
        part = part + acc
    dlam = torch.zeros(W)
    for b in range(B):                                      # the batch in order
        dlam = dlam + part[b]
    dlam = dlam * (-8.0 * torch.sigmoid(lv))
    return dx, dr, di, dlam, dh0


#: (B, L, W, lanes, with dh_T): the train shape's decomposition (32 lanes of 4
#: steps) cut narrow, a chunk longer than L / lanes (L = 13), lanes past L,
#: and the long form's 128 lanes with a ragged last chunk
LANE_CASES = [(2, 128, 8, 32, True), (2, 13, 8, 32, False), (1, 7, 16, 32, True),
              (1, 300, 8, 128, True)]


@pytest.mark.parametrize("B, L, W, lanes, with_hT", LANE_CASES)
def test_rglru_lane_decomposition_matches_plain_and_reference_vjp(B, L, W, lanes, with_hT):
    rng = np.random.default_rng(L + W + lanes)
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
    gt = torch.tensor(dht) if with_hT else None
    got = rglru_bwd_lanes(*t, out, torch.tensor(dh), gt, lanes=lanes)
    plain = RG.rglru_scan_bwd_plain(*t, out, torch.tensor(dh), gt)
    for name, g, p, w in zip(("dx", "dr", "di", "dlam", "dh0"), got, plain, want):
        np.testing.assert_allclose(_np(g), _np(p), **TOL32, err_msg=name)
        np.testing.assert_allclose(_np(g), _np(w), **TOL32, err_msg=name)
