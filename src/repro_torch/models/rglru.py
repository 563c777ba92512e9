"""RG-LRU recurrent blocks (recurrentgemma / Griffin [arXiv:2402.19427]),
forward.

Gated linear recurrence::

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates and the recurrence run in one pass through
:func:`repro_torch.kernels.ops.rglru_scan` (the CUDA kernel on the card,
its plain version on the CPU), for a prefill and for a decode step alike,
seeded with the carried state ``h0``: one launch per layer and engine call.
The gates' pre-activations go to the kernel, which applies the sigmoids.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import dense_init
from .config import ModelConfig

__all__ = ["rglru_init", "rglru_apply", "init_lru_state"]


def rglru_init(gen, cfg: ModelConfig, *, device="cpu", stack: int = 0) -> Dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = cfg.torch_dtype
    kw = dict(device=device, stack=stack)
    lead = (stack,) if stack else ()
    # Lambda parameterised so a^c in (0.9, 0.999) at init
    lam = torch.log(torch.expm1(torch.linspace(0.35, 0.9, w, dtype=torch.float32)))
    return {
        # linear block in/out (Griffin recurrent block: proj -> conv ->
        # rg-lru -> proj, with a gated branch)
        "in_x": dense_init(gen, (d, w), dt, **kw),
        "in_gate": dense_init(gen, (d, w), dt, **kw),
        "conv": dense_init(gen, (cfg.conv_width, w), dt, scale=0.5, **kw),
        "w_r": dense_init(gen, (w, w), dt, scale=0.02, **kw),
        "w_i": dense_init(gen, (w, w), dt, scale=0.02, **kw),
        "lam": lam.to(device).expand(lead + (w,)).clone(),
        "out": dense_init(gen, (w, d), dt, **kw),
    }


def _conv1d(x, w, state=None):
    width = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, width - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(ctx[:, i: i + x.shape[1]] * w[i] for i in range(width))
    new_state = ctx[:, -(width - 1):] if width > 1 else None
    return out, new_state


def rglru_apply(
    params: Dict,
    x: torch.Tensor,                 # (B, L, D)
    cfg: ModelConfig,
    state: Optional[Dict] = None,    # {"h": (B, W), "conv": (B, cw-1, W)}
) -> Tuple[torch.Tensor, Optional[Dict]]:
    xb = torch.matmul(x, params["in_x"])
    gate = F.gelu(torch.matmul(x, params["in_gate"]), approximate="tanh")

    conv_state = state["conv"] if state is not None else None
    xb, new_conv = _conv1d(xb, params["conv"], conv_state)

    r = torch.matmul(xb, params["w_r"])      # pre-activations: the scan
    i = torch.matmul(xb, params["w_i"])      # applies the sigmoids
    if state is None:
        h0 = torch.zeros((x.shape[0], xb.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        h0 = state["h"]
    h, h_last = ops.rglru_scan(xb, r, i, params["lam"], h0)

    new_state = None
    if state is not None:
        new_state = {"h": h_last.to(cfg.torch_dtype), "conv": new_conv}
    out = torch.matmul(h.to(x.dtype) * gate, params["out"])
    return out, new_state


def init_lru_state(cfg: ModelConfig, batch: int, layers: int, device) -> Dict:
    w = cfg.lru_width or cfg.d_model
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "h": torch.zeros((layers, batch, w), **kw),
        "conv": torch.zeros((layers, batch, cfg.conv_width - 1, w), **kw),
    }
