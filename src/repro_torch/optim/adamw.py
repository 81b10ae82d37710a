"""AdamW (port of ``repro/optim/adamw.py``) — the production optimizer for
the LM-family configs.

IntSGD composes with any server-side optimizer: the compression happens on
the raw stochastic gradient, and the moment state depends on the gradient
history only through the decoded aggregate. On the fused route the
(mu, nu, count) state is advanced by the fused kernels
(``optim.base.FUSED_STATE_TENSORS["adamw"]``); ``update`` here is the
unfused rule on whole trees, in the JAX package's order.

§4.1 correction: the first moment is an EMA (m = b1·m + (1-b1)·g) whose
steady state carries the full gradient, so quantization noise injected into
the applied update is amplified by 1/(1-b1), as heavy-ball momentum
amplifies it by 1/(1-μ) — hence ``dx_scale = 1-b1``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import sqrt_rn
from repro_torch.optim.base import Optimizer


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        device = next(iter(params.values())).device
        return {
            "mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(grads, state, params, lr):
        count = state["count"] + 1
        t = count.to(torch.float32)
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * torch.square(g)
              for k, g in grads.items()}
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(k):
            step = (mu[k] / bc1) / (sqrt_rn(nu[k] / bc2) + eps)
            return -lr * (step + weight_decay * params[k].to(torch.float32))

        return {k: upd(k) for k in grads}, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(
        init=init,
        update=update,
        dx_scale=1.0 - b1,  # §4.1: the m-EMA amplifies injected noise 1/(1-b1)
        kind="adamw",
        hyper=dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay),
        fused_kernel="adamw",
    )
