"""Checkpoint save/restore (fault tolerance), in the reference's format.

One numpy ``.npz`` per step, named ``step_XXXXXXXX.npz``, whose keys are
the state tree's flattened key paths (``params/layers/attn/wq``,
``opt_state/m/...``, ``opt_state/step``, ``step``); written to a temp name
and renamed, so a crash leaves no half-written step; only the newest
``keep`` steps are kept.  A checkpoint written by either package restores
in the other.

bfloat16 leaves are written as the reference writes them: numpy has no
bfloat16, so they land as 2-byte void payloads (``|V2``).
:func:`to_tensor` reads such a payload back by viewing it as bfloat16
when the target leaf is bfloat16 (the reference's own restore cannot:
ROADMAP C13).
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "to_numpy", "to_tensor"]


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the reference's ``np.asarray`` gives it: a torch tensor
    moves to the host, and bfloat16 becomes its 2-byte payload (``|V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A restored array as a tensor shaped, typed and placed as ``like``.
    A 2-byte void payload is a bfloat16 leaf's bits, read as such."""
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {arr.shape} != {tuple(like.shape)}")
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise TypeError(f"a {arr.dtype} payload restores only into bfloat16, not {like.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        flat: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: to_numpy(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.npz"

    def save(self, step: int, state: Dict[str, Any]) -> Path:
        flat = _flatten(state)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        os.close(fd)
        try:
            np.savez(tmp, **flat)
            # np.savez appends .npz to a name without it
            produced = tmp if tmp.endswith(".npz") else tmp + ".npz"
            os.replace(produced, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self._gc()
        return self._path(step)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(
            int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.npz")
        )

    def restore(self, step: int) -> Dict[str, Any]:
        """Returns a nested dict tree rebuilt from flattened keys."""
        data = np.load(self._path(step))
        tree: Dict[str, Any] = {}
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
        return tree

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            self._path(s).unlink(missing_ok=True)
