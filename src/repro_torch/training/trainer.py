"""Training loop: the train step with sharding, gradient accumulation
and checkpoint/restore-based fault tolerance.

The reference jits its step and donates the parameter and optimizer
buffers; here the step runs eagerly: ``loss.backward()`` through the
model (attention's, ``moe_gmm``'s, SSD's and RG-LRU's backwards on their
kernels), then AdamW updates every leaf in place and the gradients are
freed.

``mesh=`` (a DeviceMesh over ``("data", "model")``, e.g.
:meth:`repro_torch.distribution.ElasticMesh.mesh_for`): the parameters
and both AdamW moments become DTensors placed by ``param_specs(cfg,
params, fsdp=tcfg.fsdp)``, the batch stays a plain tensor that every
rank holds whole (the reference's ``in_shardings=(..., None)``), and the
step runs under ``implicit_replication``, so the model's constraints and
expert parallelism act.  Every rank runs the same loop.  Checkpoints
gather to full tensors on save (rank 0 writes) and re-shard on restore:
the same ``.npz`` payload resumes on any mesh, or with none.

Used by ``launch/train.py`` and ``chip_smoke.py``'s ``train`` and
``mesh_train`` phases.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from .._device import resolve_device
from ..distribution.sharding import param_specs, to_placements
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
    """``Trainer(cfg, tcfg, mesh=None, seed=0, device="cuda")``: parameters
    from ``init_params`` on a generator seeded with ``seed`` (on a mesh,
    drawn whole on every rank and then sharded), AdamW moments in float32
    (``adamw_init`` without ``state_dtype``, as the reference's trainer
    calls it).  Every stack of the zoo trains."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = LM(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(cfg, device=self.device, generator=gen)
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh, got {type(mesh).__name__}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a trainer on {self.device}")
            specs = param_specs(cfg, self.params, fsdp=tcfg.fsdp)
            self.params = _tree_map(
                lambda t, s: distribute_tensor(t, mesh, to_placements(s, mesh, t.shape)),
                self.params, specs)
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
        g_acc: List[torch.Tensor] = [
            torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
            if isinstance(p, DTensor) else
            torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
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
        with self._on_mesh():
            loss, grads = self._grads(batch)
            gtree = _like(self.params, iter(grads))
            del grads
            gn = adamw_update(self.tcfg.optimizer, self.params, gtree, self.opt_state)
        return loss, gn

    def _on_mesh(self):
        """On a mesh: plain tensors (the batch, positions, masks) count as
        replicated wherever they meet a DTensor."""
        return implicit_replication() if self.mesh is not None else contextlib.nullcontext()

    def state(self) -> Dict[str, Any]:
        """The checkpoint state, DTensors gathered to full tensors on the
        host one leaf at a time (a collective: every rank calls it)."""
        whole = lambda t: t.full_tensor().detach().cpu() if isinstance(t, DTensor) else t  # noqa: E731
        return {
            "params": _tree_map(whole, self.params),
            "opt_state": {"m": _tree_map(whole, self.opt_state["m"]),
                          "v": _tree_map(whole, self.opt_state["v"]),
                          "step": self.opt_state["step"]},
            "step": self.step,
        }

    def save(self, step: int) -> None:
        """Gather and write a checkpoint (on a mesh, rank 0 writes)."""
        state = self.state()
        if self.mesh is None or dist.get_rank() == 0:
            self.ckpt.save(step, state)
        if self.mesh is not None:
            dist.barrier()

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
            _tree_map(_load, self.params, state["params"])
            opt = state["opt_state"]
            _tree_map(_load, self.opt_state["m"], opt["m"])
            _tree_map(_load, self.opt_state["v"], opt["v"])
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
                self.save(self.step)
        return {"history": history, "final_step": self.step}


def _load(leaf: torch.Tensor, arr) -> None:
    """Copy a restored array into ``leaf``; a DTensor takes its own shard
    of the full array (no communication)."""
    full = to_tensor(arr, leaf)
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        full = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim, run_check=False)
        leaf.to_local().copy_(full.redistribute(mesh, leaf.placements).to_local())
    else:
        leaf.copy_(full)


def _like(tree, leaves: Iterator):
    """``tree``'s structure filled from ``leaves`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
