"""Learning-rate schedules, pure functions of the step counter (the port of
``repro.optim.schedule``), in float32 on the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up from 0 over ``warmup_steps``, then a cosine from
    ``base_lr`` down to ``min_ratio * base_lr`` at ``total_steps``."""
    step = _step(step)
    warm = base_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, base_lr: float) -> torch.Tensor:
    return torch.full((), base_lr, dtype=torch.float32,
                      device=_step(step).device)
