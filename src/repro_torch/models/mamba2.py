"""Mamba-2 blocks — SSD (state-space duality) [arXiv:2405.21060], forward.

The chunked scan of a prefill goes through
:func:`repro_torch.kernels.ops.ssd_chunked` (the CUDA intra-chunk kernel on
the card, its plain version on the CPU).  :func:`ssd_chunked` here is the
reference's model-level chunked algorithm in plain torch, an independent
formulation that the op is held against.  Decode keeps an O(1) recurrent
state (B, H, P, N) and a conv ring buffer; its single step is torch ops.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import dense_init, rms_norm
from .config import ModelConfig

__all__ = ["mamba_init", "mamba_apply", "init_ssm_state", "ssd_chunked"]


# ---------------------------------------------------------------------------
# SSD core (chunked; faithful to the Mamba-2 minimal listing)
# ---------------------------------------------------------------------------
def ssd_chunked(
    x: torch.Tensor,      # (B, L, H, P)
    dt: torch.Tensor,     # (B, L, H)   softplus-activated step sizes
    A: torch.Tensor,      # (H,)        negative decay rates
    Bm: torch.Tensor,     # (B, L, G, N)
    Cm: torch.Tensor,     # (B, L, G, N)
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,L,H,P), final_state (B,H,P,N)), in ``x``'s dtype.

    Within each chunk the quadratic "attention-like" form is used;
    states are carried across chunks in a loop (linear in L).
    """
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    assert h % g == 0
    hpg = h // g
    chunk = min(chunk, l)
    nb = -(-l // chunk)
    pad = nb * chunk - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))

    xc = x.reshape(b, nb, chunk, h, p)
    dtc = dt.reshape(b, nb, chunk, h)
    Bc = Bm.reshape(b, nb, chunk, g, n)
    Cc = Cm.reshape(b, nb, chunk, g, n)

    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for k in range(nb):
        xk, dtk, Bk, Ck = xc[:, k], dtc[:, k], Bc[:, k], Cc[:, k]
        ack = torch.cumsum(dtk.float() * A, dim=1)                  # (B,C,H)
        # intra-chunk quadratic form: weight_{t,s} = C_t.B_s *
        #   exp(acum_t - acum_s) * dt_s   for s <= t; masked INSIDE the exp
        seg = ack[:, :, None, :] - ack[:, None, :, :]                # (B,C,C,H)
        seg = seg.masked_fill(~causal[None, :, :, None], -float("inf"))
        decay = torch.exp(seg)
        cb = torch.einsum("bcgn,bsgn->bcsg", Ck.float(), Bk.float())
        cb = torch.repeat_interleave(cb, hpg, dim=-1)                # (B,C,C,H)
        w = cb * decay * dtk[:, None, :, :]
        y_intra = torch.einsum("bcsh,bshp->bchp", w, xk.float())
        # inter-chunk: y += C_t exp(acum_t) state_in
        Ch = torch.repeat_interleave(Ck, hpg, dim=2) if g != h else Ck   # (B,C,H,N)
        y_inter = torch.einsum("bchn,bhpn,bch->bchp", Ch.float(), state, torch.exp(ack))
        # state update: state' = exp(acum_C) state + sum_s decay_to_end dt B x
        d2e = torch.exp(ack[:, -1:, :] - ack)                        # (B,C,H)
        Bh = torch.repeat_interleave(Bk, hpg, dim=2) if g != h else Bk
        contrib = torch.einsum("bch,bchn,bchp->bhpn", dtk * d2e, Bh.float(), xk.float())
        state = state * torch.exp(ack[:, -1, :])[:, :, None, None] + contrib
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, nb * chunk, h, p)
    if pad:
        y = y[:, :l]
    return y, state.to(x.dtype)


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------
def mamba_init(gen, cfg: ModelConfig, *, device="cpu", stack: int = 0) -> Dict:
    d, din = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dt = cfg.torch_dtype
    in_dim = 2 * din + 2 * g * n + h
    kw = dict(device=device, stack=stack)
    lead = (stack,) if stack else ()
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32))
    return {
        "in_proj": dense_init(gen, (d, in_dim), dt, **kw),
        "conv": dense_init(gen, (cfg.conv_width, din + 2 * g * n), dt, scale=0.5, **kw),
        "A_log": a_log.to(device).expand(lead + (h,)).clone(),
        "D": torch.ones(lead + (h,), **f32),
        "dt_bias": torch.zeros(lead + (h,), **f32),
        "norm": torch.ones(lead + (din,), dtype=dt, device=device),
        "out_proj": dense_init(gen, (din, d), dt, **kw),
    }


def _split_in(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din: 2 * din + 2 * g * n]
    dt = zxbcdt[..., 2 * din + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d; ``state`` is the (B, W-1, C) ring buffer
    for decode.  Returns (silu(out), new_state)."""
    width = w.shape[0]
    if state is None:
        ctx = F.pad(xbc, (0, 0, width - 1, 0))
    else:
        ctx = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    out = sum(ctx[:, i: i + xbc.shape[1]] * w[i] for i in range(width))
    new_state = ctx[:, -(width - 1):] if width > 1 else None
    return F.silu(out), new_state


def mamba_apply(
    params: Dict,
    x: torch.Tensor,                  # (B, L, D)
    cfg: ModelConfig,
    state: Optional[Dict] = None,     # {"ssm": (B,H,P,N), "conv": (B,W-1,C)}
) -> Tuple[torch.Tensor, Optional[Dict]]:
    b, l, _ = x.shape
    din, g, n, h, p = (
        cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    )
    zxbcdt = torch.matmul(x, params["in_proj"])
    z, xbc, dt = _split_in(cfg, zxbcdt)

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv"], conv_state)

    xs = xbc[..., :din].reshape(b, l, h, p)
    Bm = xbc[..., din: din + g * n].reshape(b, l, g, n)
    Cm = xbc[..., din + g * n:].reshape(b, l, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    if state is None:
        y, _ = ops.ssd_chunked(xs, dt, A, Bm, Cm, chunk=cfg.ssd_chunk)
        new_state = None
    elif l == 1:
        y, final = _ssm_step(xs, dt, A, Bm, Cm, state["ssm"], h // g)
        new_state = {"ssm": final, "conv": new_conv}
    else:  # stateful prefill: chunked scan seeded with the carried state
        y, final = ops.ssd_chunked(xs, dt, A, Bm, Cm, chunk=cfg.ssd_chunk,
                                   init_state=state["ssm"])
        new_state = {"ssm": final, "conv": new_conv}

    y = y + xs * params["D"][None, None, :, None]
    y = y.reshape(b, l, din).to(x.dtype)   # D is f32; keep model dtype
    y = rms_norm(y * F.silu(z), params["norm"])
    return torch.matmul(y, params["out_proj"]), new_state


def _ssm_step(xs, dt, A, Bm, Cm, ssm, hpg):
    """Single-token recurrence: h' = exp(dt*A) h + dt * B x^T; y = C h.
    The new state is float32 (the float32 decay promotes it), as in the
    reference."""
    x0 = xs[:, 0].float()                                 # (B,H,P)
    d0 = dt[:, 0]                                         # (B,H)
    B0 = torch.repeat_interleave(Bm[:, 0], hpg, dim=1).float()   # (B,H,N)
    C0 = torch.repeat_interleave(Cm[:, 0], hpg, dim=1).float()
    decay = torch.exp(d0 * A)
    upd = torch.einsum("bh,bhn,bhp->bhpn", d0, B0, x0)
    new = ssm.float() * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new, C0)
    return y[:, None], new


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int, device) -> Dict:
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "ssm": torch.zeros((layers, batch, h, p, n), **kw),
        "conv": torch.zeros((layers, batch, cfg.conv_width - 1, conv_ch), **kw),
    }
