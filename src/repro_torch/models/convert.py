"""Carry a parameter tree of the reference package into the port.

The reference keeps parameters as a nested dict of arrays with the
layers stacked on a leading axis; the port keeps the same tree of torch
tensors.  Tests hand the reference's freshly initialised tree across as
NumPy arrays, so both packages run on the same weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import ModelConfig
from .lm import init_params

__all__ = ["params_from_reference"]


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any], device="cuda") -> Dict:
    """``tree``: the reference's parameter tree with NumPy leaves (bf16
    leaves passed as float32 arrays).  Returns the port's tree on
    ``device``, each leaf in the dtype the port's ``init_params`` gives
    it; raises on a missing, extra or misshapen leaf."""
    schema = init_params(cfg, device="meta")

    def conv(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(
                    f"{path or 'params'}: keys {sorted(got) if isinstance(got, dict) else type(got)} "
                    f"!= {sorted(want)}"
                )
            return {k: conv(want[k], got[k], f"{path}/{k}") for k in want}
        arr = np.asarray(got)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(want.shape)}")
        if arr.dtype.kind != "f":
            raise TypeError(f"{path}: dtype {arr.dtype} is not a float (pass bf16 as float32)")
        return torch.tensor(arr, dtype=torch.float32).to(dtype=want.dtype, device=device)

    return conv(schema, tree, "")
