"""Optimizer interface and the fused-route registry (port of
``repro/optim/base.py``: the heavy-ball SGD and AdamW kernels, plus
``apply_updates`` and ``chain_clip_by_global_norm`` for the simulator).

An Optimizer is a pair of functions, ``init(params) -> state`` and
``update(grads, state, params, lr) -> (updates, state)``, plus

  * ``dx_scale``: converts the applied update Δx into the gradient-
    equivalent displacement the IntSGD α rules are analysed for (paper §4.1).
    Heavy-ball momentum μ amplifies the steady-state update by 1/(1-μ), so
    dx_scale = 1-μ; the trainer scales the ||Δx||² it feeds the α rule by
    dx_scale²;
  * ``fused_kernel``: the fused decode+update kernel the rule can ride
    ("sgd" | "adamw"), or None — the optimizer half of the fused-route capability
    contract (the compressor half is ``Compressor.fused_capable``).

The per-kernel state layout and scalar schedule live here so the step and
the wire codecs stay kernel-agnostic. Both kernels, ``sgd`` and ``adamw``,
are ported; AdamW's scalar state (``count``) is an int32 tensor on the
card, and its bias corrections are computed there, so the step makes no
host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import sqrt_rn

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[..., tuple]  # (grads, state, params, lr) -> (updates, state)
    dx_scale: float = 1.0  # applied-update -> gradient-equivalent factor
    kind: str = "custom"
    hyper: Optional[Mapping[str, Any]] = None  # static hyperparameters
    fused_kernel: Optional[str] = None  # fused decode+update kernel capability


def apply_updates(params, updates):
    """x + Δ per leaf, in the param's own type (the sum in float32 for a
    bf16 param, as the JAX package's type promotion computes it)."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def chain_clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Gradient clipping wrapper (applied to the aggregated gradient):
    g · min(1, max_norm / (||g|| + 1e-12)), ||g||² through the block-norms
    kernel on the card. The wrapped update is opaque, so the fused
    capability does not survive the chain (on the fused route use
    ``build_train_step(clip_norm=...)``, which folds the clip factor into
    the kernels' scalar vector)."""

    def update(grads, state, params, lr):
        gn = torch.sqrt(torch.sum(torch.stack([ops.sq_norm(g.float()) for g in grads.values()])))
        # a tensor over a tensor: PyTorch's Python-scalar / tensor
        # multiplies by the reciprocal, one rounding more than JAX's
        scale = torch.clamp(torch.full_like(gn, max_norm) / (gn + 1e-12), max=1.0)
        return opt.update({k: g * scale for k, g in grads.items()}, state, params, lr)

    return dataclasses.replace(opt, update=update, kind="custom", fused_kernel=None)


# per-param f32 state tensors each fused kernel reads and writes, in the
# order of the kernel's arguments
FUSED_STATE_TENSORS = {"sgd": ("mom",), "adamw": ("mu", "nu")}
# replicated scalar state carried outside the kernels
FUSED_STATE_SCALARS = {"sgd": (), "adamw": ("count",)}
# scalar tail after the per-leaf [inv_nalpha, clip] header. omb1/omb2 are
# 1-b1 / 1-b2 PRE-ROUNDED from the Python floats, so the kernels multiply by
# the same f32 constants as the JAX package's ``(1 - b1) * g``; recomputing
# 1-b1 in f32 is one ULP off, which the bf16 forward amplifies.
FUSED_SCALAR_TAIL = {
    "sgd": ("lr", "mu", "wd"),
    "adamw": ("lr", "b1", "omb1", "b2", "omb2", "eps", "wd", "bc1", "bc2"),
}


def _kernel_of(opt: Optimizer) -> str:
    kern = opt.fused_kernel
    if kern is None:
        raise ValueError(
            f"optimizer kind={opt.kind!r} exposes no fused kernel "
            "(Optimizer.fused_kernel is None)"
        )
    if kern not in FUSED_STATE_TENSORS:
        raise ValueError(f"unknown fused kernel {kern!r}")
    return kern


def fused_state_init(opt: Optimizer, params):
    """Zero fused-route optimizer state: one f32 tensor per param per
    ``FUSED_STATE_TENSORS`` entry, one int32 scalar per
    ``FUSED_STATE_SCALARS`` entry, on the params' device."""
    kern = _kernel_of(opt)
    state = {
        name: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        for name in FUSED_STATE_TENSORS[kern]
    }
    device = next(iter(params.values())).device
    for name in FUSED_STATE_SCALARS[kern]:
        state[name] = torch.zeros((), dtype=torch.int32, device=device)
    return state


def fused_step_scalars(opt: Optimizer, opt_state, eta: torch.Tensor):
    """One step of the kernel's scalar tail, as f32 tensors on eta's device
    in ``FUSED_SCALAR_TAIL`` order, plus the advanced scalar state. AdamW's
    bias corrections 1 − b^t are f32 tensor ops on the card (t from the
    int32 count): no host sync."""
    kern = _kernel_of(opt)
    h = opt.hyper or {}
    full = lambda v: torch.full((), v, dtype=torch.float32, device=eta.device)
    if kern == "sgd":
        return (eta, full(h["momentum"]), full(h["weight_decay"])), {}
    b1, b2 = float(h["b1"]), float(h["b2"])
    count = opt_state["count"] + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    return (
        eta, full(b1), full(1.0 - b1), full(b2), full(1.0 - b2),
        full(h["eps"]), full(h["weight_decay"]), bc1, bc2,
    ), {"count": count}


def fused_reference_update(opt: Optimizer, ghat, params, opt_state, eta):
    """Unfused reference of the fused kernels' arithmetic on whole trees —
    the exact (step-0) path, which has a decoded float aggregate and no
    integer payload. The JAX package's order, one op per rounding (no FMA);
    AdamW's second moment here is omb2·(g·g), as in the JAX package's
    exact step, where the kernels compute (omb2·g)·g."""
    kern = _kernel_of(opt)
    tail, new_scalars = fused_step_scalars(opt, opt_state, eta)
    if kern == "sgd":
        lr, mu, wd = tail
        new_params, new_mom = {}, {}
        for k, p in params.items():
            p32 = p.to(torch.float32)
            g32 = ghat[k].to(torch.float32) + wd * p32
            m32 = mu * opt_state["mom"][k].to(torch.float32) + g32
            new_params[k] = (p32 - lr * m32).to(p.dtype)
            new_mom[k] = m32
        return new_params, {"mom": new_mom, **new_scalars}
    lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2 = tail
    new_params, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        p32 = p.to(torch.float32)
        g32 = ghat[k].to(torch.float32)
        m32 = b1 * opt_state["mu"][k].to(torch.float32) + omb1 * g32
        v32 = b2 * opt_state["nu"][k].to(torch.float32) + omb2 * torch.square(g32)
        step = (m32 / bc1) / (sqrt_rn(v32 / bc2) + eps)
        new_params[k] = (p32 - lr * (step + wd * p32)).to(p.dtype)
        new_mu[k], new_nu[k] = m32, v32
    return new_params, {"mu": new_mu, "nu": new_nu, **new_scalars}
