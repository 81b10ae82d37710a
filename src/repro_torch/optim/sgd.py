"""SGD with momentum + weight decay, torch.optim.SGD semantics (port of
``repro/optim/sgd.py``): weight decay is added to the aggregated gradient
before momentum; m = μ m + g; update = -lr · m."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer


def sgd(momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False):
    def init(params):
        if momentum == 0.0:
            return ()
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    def update(grads, state, params, lr):
        if weight_decay:
            grads = {
                k: g + weight_decay * params[k].to(torch.float32)
                for k, g in grads.items()
            }
        if momentum == 0.0:
            return {k: -lr * g for k, g in grads.items()}, state
        new_m = {k: momentum * state[k] + g for k, g in grads.items()}
        eff = (
            {k: g + momentum * new_m[k] for k, g in grads.items()}
            if nesterov else new_m
        )
        return {k: -lr * m for k, m in eff.items()}, new_m

    # momentum amplifies the applied update (and the injected quantization
    # noise) by 1/(1-μ) at steady state; the α rule sees (1-μ)²||Δx||².
    return Optimizer(
        init=init,
        update=update,
        dx_scale=1.0 - momentum,
        kind="sgd",
        hyper=dict(momentum=momentum, weight_decay=weight_decay, nesterov=nesterov),
        # the fused decode+momentum-SGD kernel is the heavy-ball form only
        fused_kernel=None if nesterov else "sgd",
    )
