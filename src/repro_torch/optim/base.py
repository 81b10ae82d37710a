"""Optimizer interface and the fused-route registry (port of
``repro/optim/base.py``, the heavy-ball SGD kernel).

An Optimizer is a pair of functions, ``init(params) -> state`` and
``update(grads, state, params, lr) -> (updates, state)``, plus

  * ``dx_scale``: converts the applied update Δx into the gradient-
    equivalent displacement the IntSGD α rules are analysed for (paper §4.1).
    Heavy-ball momentum μ amplifies the steady-state update by 1/(1-μ), so
    dx_scale = 1-μ; the trainer scales the ||Δx||² it feeds the α rule by
    dx_scale²;
  * ``fused_kernel``: the fused decode+update kernel the rule can ride
    ("sgd"), or None — the optimizer half of the fused-route capability
    contract (the compressor half is ``Compressor.fused_capable``).

The per-kernel state layout and scalar schedule live here so the step and
the wire codecs stay kernel-agnostic. The AdamW kernel is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[..., tuple]  # (grads, state, params, lr) -> (updates, state)
    dx_scale: float = 1.0  # applied-update -> gradient-equivalent factor
    kind: str = "custom"
    hyper: Optional[Mapping[str, Any]] = None  # static hyperparameters
    fused_kernel: Optional[str] = None  # fused decode+update kernel capability


# per-param f32 state tensors each fused kernel reads and writes, in the
# order of the kernel's arguments
FUSED_STATE_TENSORS = {"sgd": ("mom",)}
# replicated scalar state carried outside the kernels
FUSED_STATE_SCALARS = {"sgd": ()}
# scalar tail after the per-leaf [inv_nalpha, clip] header
FUSED_SCALAR_TAIL = {"sgd": ("lr", "mu", "wd")}


def _kernel_of(opt: Optimizer) -> str:
    kern = opt.fused_kernel
    if kern is None:
        raise ValueError(
            f"optimizer kind={opt.kind!r} exposes no fused kernel "
            "(Optimizer.fused_kernel is None)"
        )
    if kern not in FUSED_STATE_TENSORS:
        raise ValueError(f"fused kernel {kern!r} is not ported yet")
    return kern


def fused_state_init(opt: Optimizer, params):
    """Zero fused-route optimizer state: one f32 tensor per param per
    ``FUSED_STATE_TENSORS`` entry."""
    kern = _kernel_of(opt)
    return {
        name: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        for name in FUSED_STATE_TENSORS[kern]
    }


def fused_step_scalars(opt: Optimizer, opt_state, eta: torch.Tensor):
    """One step of the kernel's scalar tail, as f32 tensors on eta's device
    in ``FUSED_SCALAR_TAIL`` order, plus the advanced scalar state."""
    _kernel_of(opt)
    h = opt.hyper or {}
    full = lambda v: torch.full((), v, dtype=torch.float32, device=eta.device)
    return (eta, full(h["momentum"]), full(h["weight_decay"])), {}


def fused_reference_update(opt: Optimizer, ghat, params, opt_state, eta):
    """Unfused reference of the fused kernel's arithmetic on whole trees —
    the exact (step-0) path, which has a decoded float aggregate and no
    integer payload. Same roundings as the kernel (no FMA)."""
    (lr, mu, wd), new_scalars = fused_step_scalars(opt, opt_state, eta)
    new_params, new_mom = {}, {}
    for k, p in params.items():
        p32 = p.to(torch.float32)
        g32 = ghat[k].to(torch.float32) + wd * p32
        m32 = mu * opt_state["mom"][k].to(torch.float32) + g32
        new_params[k] = (p32 - lr * m32).to(p.dtype)
        new_mom[k] = m32
    return new_params, {"mom": new_mom, **new_scalars}
