"""Inference request model."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

__all__ = ["Request", "RequestState"]


class RequestState(enum.Enum):
    QUEUED = 0
    PREFILLING = 1
    DECODING = 2
    DONE = 3
    DROPPED = 4


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32 token ids
    max_new_tokens: int = 32
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None  # absolute; None = best effort
    state: RequestState = RequestState.QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1                      # batch slot while active
    pos: int = 0                        # next cache position
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens
