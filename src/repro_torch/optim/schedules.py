"""Learning-rate schedules (port of ``repro/optim/schedules.py``: the two
the train loop uses). Each returns ``f(step, device) -> lr``, a float32
scalar tensor computed on ``device`` in the JAX package's float32 order, so
η — and the α that depends on it — match bit for bit without a host copy."""
from __future__ import annotations

import torch


def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def constant(lr: float):
    return lambda step, device="cpu": _f32(lr, device)


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
