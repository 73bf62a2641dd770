"""Learning-rate schedules (pure functions of the step counter).

The port of the JAX package's ``repro/training/schedule.py``: each returns
an f32 0-dim tensor, computed in f32 as the reference's ``jnp`` does, on
the step's device (the host for a Python int, where the optimizer reads it
as a scalar without a host sync).
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, floor: float = 0.1):
    step = torch.as_tensor(step).float()
    warm = peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    # the cosine of the f32 angle, correctly rounded to f32: PyTorch's f32
    # cos is an ulp off XLA's at some angles, which 1 + cos near the end of
    # the schedule turns into several ulps of the rate
    c = torch.cos((math.pi * t).double()).float()
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + c))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_):
    return torch.full((), peak_lr, dtype=torch.float32)
