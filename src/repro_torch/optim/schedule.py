"""LR schedules (twin of repro.optim.schedule): pure functions of the step
counter, computed in fp32, the cosine glibc's float32 cosf (data.libm), as
XLA's CPU code computes it."""
from __future__ import annotations

import math

import torch

from repro_torch.data import libm

__all__ = ["cosine_warmup"]


def cosine_warmup(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to floor*peak; a 0-d fp32 tensor on
    the step's device (a Python int step: on the CPU).  Step 0 trains too:
    its rate is peak_lr / warmup_steps.  The divisors are 0-d tensors, not
    Python numbers, so the card divides as the CPU does."""
    if isinstance(step, torch.Tensor):
        s = step.to(torch.float32)
    else:
        s = torch.tensor(float(step), dtype=torch.float32, device="cpu")
    f32 = dict(dtype=torch.float32, device=s.device)
    warm = (s + 1.0) / torch.tensor(max(1.0, warmup_steps), **f32)
    span = torch.tensor(max(1.0, total_steps - warmup_steps), **f32)
    prog = torch.clamp((s - warmup_steps) / span, 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + libm.cosf(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
