"""The optimizer and learning-rate schedules: copies of ``repro/optim``."""

from .adamw import AdamW, AdamWState, global_norm
from .schedule import SCHEDULES, constant, warmup_cosine

__all__ = ["AdamW", "AdamWState", "SCHEDULES", "constant", "global_norm",
           "warmup_cosine"]
