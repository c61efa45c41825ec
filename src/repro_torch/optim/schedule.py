"""Learning-rate schedules (pure functions of the step counter).

``repro/optim/schedule.py`` in PyTorch: each schedule maps a step tensor
(any integer type, on any device) to a float32 tensor on its device, in
the reference's float32 arithmetic, so the learning rate is computed
where the step lives and an optimizer step never reads the device.
"""

from __future__ import annotations

import math

import torch


def _f32(step, x):
    return torch.full((), x, dtype=torch.float32, device=step.device)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = step.to(torch.float32)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)

    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(_f32(step, math.pi) * t))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return fn
