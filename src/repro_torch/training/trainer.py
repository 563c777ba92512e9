"""Training loop: the train step, gradient accumulation and
checkpoint/restore-based fault tolerance, on one device.

The reference jits its step and donates the parameter and optimizer
buffers; here the step runs eagerly: ``loss.backward()`` through the
model (attention's, ``moe_gmm``'s, SSD's and RG-LRU's backwards on their
kernels), then AdamW updates every leaf in place and the gradients are
freed.  Sharding across a mesh is
not ported (``mesh=`` raises).

Used by ``launch/train.py`` and ``chip_smoke.py``'s ``train`` phase.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from .._device import resolve_device
from ..models import LM, init_params
from ..models.config import ModelConfig
from .checkpoint import CheckpointManager, to_tensor
from .optimizer import AdamWConfig, _tree_map, adamw_init, adamw_update, tree_leaves

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    grad_accum: int = 1
    fsdp: bool = False
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class Trainer:
    """``Trainer(cfg, tcfg, seed=0, device="cuda")``: parameters from
    ``init_params`` on a generator seeded with ``seed``, AdamW moments in
    float32 (``adamw_init`` without ``state_dtype``, as the reference's
    trainer calls it).  Every stack of the zoo trains."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None, seed: int = 0,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) is not ported yet: ROADMAP: distribution/* and "
                "launch/{mesh,dryrun}.py (A8)"
            )
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = LM(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(cfg, device=self.device, generator=gen)
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.opt_state = adamw_init(self.params)
        self.step = 0
        self.ckpt = (
            CheckpointManager(tcfg.checkpoint_dir)
            if tcfg.checkpoint_dir else None
        )

    # ------------------------------------------------------------------
    def _grads(self, batch: Dict[str, torch.Tensor]):
        """Loss and gradient leaves (sorted-key order) of one batch; with
        ``grad_accum > 1`` the mean over micro-batches along the batch's
        leading ``accum`` axis, summed in float32 (the reference's scan)."""
        accum = self.tcfg.grad_accum
        leaves = tree_leaves(self.params)

        def one(mb):
            loss = self.model.loss(self.params, mb)
            loss.backward()
            grads = []
            for p in leaves:
                if p.grad is None:
                    raise RuntimeError(f"a parameter of shape {tuple(p.shape)} got no gradient")
                grads.append(p.grad)
                p.grad = None
            return loss.detach(), grads

        if accum <= 1:
            return one(batch)
        toks = batch["tokens"]
        if toks.dim() != 3 or toks.shape[0] != accum:
            raise ValueError(
                f"grad_accum={accum} takes micro-batches along a leading accum axis: "
                f"tokens (accum={accum}, batch/accum, seq), got {tuple(toks.shape)} "
                f"(ROADMAP C12)"
            )
        g_acc: List[torch.Tensor] = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                     for p in leaves]
        l_acc = None
        for i in range(accum):
            loss, grads = one({k: v[i] for k, v in batch.items()})
            for a, g in zip(g_acc, grads):
                a.add_(g)
            l_acc = loss if l_acc is None else l_acc + loss
            del grads
        return l_acc / accum, [a.div_(accum) for a in g_acc]

    def train_step(self, batch: Dict[str, torch.Tensor]):
        """One step in place: gradients, then AdamW on every leaf.
        Returns (loss, grad norm) as 0-d tensors on the device."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        loss, grads = self._grads(batch)
        gtree = _like(self.params, iter(grads))
        del grads
        gn = adamw_update(self.tcfg.optimizer, self.params, gtree, self.opt_state)
        return loss, gn

    # ------------------------------------------------------------------
    def restore_if_available(self) -> bool:
        """Fault tolerance: resume from the latest checkpoint."""
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state = self.ckpt.restore(latest)
        with torch.no_grad():
            _tree_map(lambda a, b: a.copy_(to_tensor(b, a)), self.params, state["params"])
            opt = state["opt_state"]
            _tree_map(lambda a, b: a.copy_(to_tensor(b, a)), self.opt_state["m"], opt["m"])
            _tree_map(lambda a, b: a.copy_(to_tensor(b, a)), self.opt_state["v"], opt["v"])
        self.opt_state["step"] = torch.tensor(int(opt["step"]), dtype=torch.int32)
        self.step = int(state["step"])
        return True

    def fit(self, data: Iterator[Dict[str, torch.Tensor]],
            on_log: Optional[Callable] = None) -> Dict[str, Any]:
        history = []
        while self.step < self.tcfg.steps:
            batch = next(data)
            t0 = time.time()
            loss, gn = self.train_step(batch)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == 1:
                loss_f = loss.item()
                rec = {
                    "step": self.step,
                    "loss": loss_f,
                    "grad_norm": gn.item(),
                    "dt_s": time.time() - t0,
                }
                history.append(rec)
                if on_log:
                    on_log(rec)
            if (
                self.ckpt is not None
                and self.step % self.tcfg.checkpoint_every == 0
            ):
                self.ckpt.save(
                    self.step,
                    {
                        "params": self.params,
                        "opt_state": self.opt_state,
                        "step": self.step,
                    },
                )
        return {"history": history, "final_step": self.step}


def _like(tree, leaves: Iterator):
    """``tree``'s structure filled from ``leaves`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
