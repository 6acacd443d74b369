"""LR schedules: a copy of ``repro/optim/schedule.py``.  Pure functions of
the step, computed in float32 as the reference computes them; a step that
is a tensor stays on its device (no host read)."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_ratio`` of peak (scale in
    [0, 1], multiply by base LR)."""
    step = _f32(step)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, **_) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32,
                      device=step.device if isinstance(step, torch.Tensor)
                      else None)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
