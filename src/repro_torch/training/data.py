"""Synthetic sharded data pipeline.

Deterministic per-step token streams (seeded by (epoch, step, shard))
with host-side prefetch: the structure a real loader would have, minus
storage I/O.  ``_batch_for`` is the reference's, so the two packages'
batches are bit-identical; ``synthetic_stream`` hands them over as torch
tensors on an explicit device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..models.config import ModelConfig

__all__ = ["DataConfig", "synthetic_stream", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    num_shards: int = 1
    shard: int = 0


def _batch_for(cfg: ModelConfig, dcfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(
        (dcfg.seed * 1_000_003 + step * 131 + dcfg.shard) % (2**31 - 1)
    )
    b = dcfg.batch // dcfg.num_shards
    s = dcfg.seq_len
    if cfg.num_codebooks:
        toks = rng.randint(0, cfg.vocab_size, (b, cfg.num_codebooks, s + 1))
        return {
            "tokens": toks[:, :, :-1].astype(np.int32),
            "labels": toks[:, :, 1:].astype(np.int32),
        }
    if cfg.num_patches:
        text = s - cfg.num_patches
        toks = rng.randint(0, cfg.vocab_size, (b, text + 1))
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "patch_embeds": rng.randn(b, cfg.num_patches, cfg.d_model)
            .astype(np.float32),
        }
    toks = rng.randint(0, cfg.vocab_size, (b, s + 1))
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def synthetic_stream(
    cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0, device="cuda"
) -> Iterator[Dict[str, torch.Tensor]]:
    """Deterministic: restarting from a checkpointed step reproduces the
    exact remaining stream (fault-tolerance invariant, tested).  Batches
    land on ``device``."""
    dev = resolve_device(device)
    step = start_step
    while True:
        yield {k: torch.from_numpy(v).to(dev) for k, v in _batch_for(cfg, dcfg, step).items()}
        step += 1


class Prefetcher:
    """Background-thread prefetch of ``depth`` batches."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = False
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
                if self._done:
                    return
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._done = True
