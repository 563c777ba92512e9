"""Training substrate: optimizer, train step, checkpointing, data."""
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .trainer import Trainer, TrainConfig

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "Trainer",
    "TrainConfig",
]
