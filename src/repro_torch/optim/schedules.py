"""Learning-rate schedules (counterpart of ``repro.optim.schedules``): pure
functions of the step counter, a 0-dim integer tensor."""
from __future__ import annotations

import math

import torch


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``lr`` (counting from 1, so step 0 already trains at
    lr / warmup), then a cosine down to ``final_frac * lr`` at
    ``total_steps``; f32 arithmetic as the reference's."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32) + 1.0
        warm = lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, lr * cos)

    return schedule
