"""Learning-rate schedules (port of ``repro/optim/schedules.py``). Each
returns ``f(step, device) -> lr``, a float32 scalar tensor computed on
``device`` in the JAX package's float32 order, so η — and the α that
depends on it — match bit for bit without a host copy."""
from __future__ import annotations

import math

import torch


def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def constant(lr: float):
    return lambda step, device="cpu": _f32(lr, device)


def step_decay(lr: float, boundaries, factor: float = 0.1):
    """The paper's ResNet schedule: decay by `factor` at each boundary
    epoch/step (lr · factor^k, k the boundaries passed)."""
    bounds = tuple(int(b) for b in boundaries)

    def f(step: int, device="cpu"):
        k = _f32(float(sum(step >= b for b in bounds)), device)
        return _f32(lr, device) * torch.pow(_f32(factor, device), k)

    return f


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    """Cosine from lr down to final_frac·lr over total_steps, then flat."""

    def f(step: int, device="cpu"):
        t = torch.clamp(_f32(float(step), device) / _f32(float(total_steps), device), max=1.0)
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, device) * t))
        return _f32(lr, device) * (final_frac + (1.0 - final_frac) * cos)

    return f


def warmup_wrap(sched, warmup_steps: int):
    """Linear warmup (Goyal et al. 2017 scaling rule, used in the paper)."""

    def f(step: int, device="cpu"):
        if step < warmup_steps:
            # divide by a tensor: PyTorch's CUDA division by a Python scalar
            # multiplies by its reciprocal, which can differ in the last bit
            warm = sched(0, device) * (_f32(float(step), device) + 1.0)
            return warm / _f32(float(max(warmup_steps, 1)), device)
        return sched(step, device)

    return f
