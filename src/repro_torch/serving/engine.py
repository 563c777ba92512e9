"""Continuous-batching serving engine for one model.

Fixed-slot batching (vLLM-style static slots): a (B, max_len) KV cache
is allocated once on the device; requests claim slots, prefill writes
their prompt into the slot's cache rows, and one decode step advances
every active slot per iteration.  Slot bookkeeping is host-side; the
device work is two calls (prefill one request into a slot, decode the
whole batch), counted in ``prefill_calls`` and ``decode_calls``.

The decode step is position-uniform: it runs at the largest active
position (ROADMAP C4 records what that does to a shorter slot; the port
keeps the reference's behaviour).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from .._device import resolve_device
from ..models import LM
from ..models.config import ModelConfig
from .request import Request, RequestState

__all__ = ["EngineConfig", "ServingEngine"]


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 512
    greedy: bool = True


class ServingEngine:
    """``params`` must already lie on ``device`` (``init_params(cfg,
    device=...)`` or ``params_from_reference(..., device=...)``)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.model = LM(cfg)
        self.params = params
        self.cache = self.model.init_cache(ecfg.max_batch, ecfg.max_len, self.device)
        self.free_slots = list(range(ecfg.max_batch))
        self.active: Dict[int, Request] = {}
        self.queue: List[Request] = []
        self.prefill_calls = 0
        self.decode_calls = 0

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Prefill one request (batch 1) and copy its KV rows into batch
        slot ``slot`` (the whole row, as the reference does)."""
        self.prefill_calls += 1
        small = self.model.init_cache(1, self.ecfg.max_len, self.device)
        logits, small = self.model.prefill(self.params, {"tokens": tokens}, small)
        for key, big in self.cache.items():
            big[:, slot] = small[key][:, 0]
        return logits

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray, positions: np.ndarray,
                active: np.ndarray) -> np.ndarray:
        """One token for every active slot, at the max active position."""
        self.decode_calls += 1
        pos = int(np.max(np.where(active, positions, 0)))
        toks = torch.from_numpy(tokens).to(self.device)
        logits, self.cache = self.model.decode_step(
            self.params, {"tokens": toks}, self.cache, pos
        )
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            req = self.queue.pop(0)
            slot = self.free_slots.pop(0)
            req.slot = slot
            req.state = RequestState.PREFILLING
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)[None]
            logits = self._prefill(tokens, slot)
            req.generated.append(int(torch.argmax(logits[0])))
            req.pos = len(req.prompt)
            req.first_token_s = time.time()
            req.state = RequestState.DECODING
            self.active[slot] = req

    def step(self) -> int:
        """One engine iteration; returns #completed requests."""
        self._admit()
        if not self.active:
            return 0
        B = self.ecfg.max_batch
        toks = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int32)
        act = np.zeros((B,), bool)
        for slot, req in self.active.items():
            toks[slot, 0] = req.generated[-1]
            pos[slot] = req.pos
            act[slot] = True
        nxt = self._decode(toks, pos, act)
        done = 0
        for slot, req in list(self.active.items()):
            req.generated.append(int(nxt[slot]))
            req.pos += 1
            if req.done or req.pos >= self.ecfg.max_len - 1:
                req.state = RequestState.DONE
                req.finish_s = time.time()
                del self.active[slot]
                self.free_slots.append(slot)
                done += 1
        return done

    def run_until_drained(self, max_iters: int = 10000) -> None:
        it = 0
        while (self.queue or self.active) and it < max_iters:
            self.step()
            it += 1
