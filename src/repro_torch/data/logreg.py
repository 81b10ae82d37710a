"""ℓ2-regularized logistic regression (paper Appendix C.5; port of
``repro/data/logreg.py``).

A synthetic stand-in for the LibSVM datasets (w8a is d = 300): features with
controllable heterogeneity across workers, the regime where plain IntGD's
largest transmitted integer blows up and IntDIANA keeps it small (Fig. 6).
:func:`make_logreg` draws from a ``torch.Generator`` (other bits than the
JAX package's ``jax.random``); :meth:`LogRegProblem.from_arrays` takes
arrays made elsewhere, so a test can hand both packages the same problem.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _softplus(z: torch.Tensor) -> torch.Tensor:
    """log(1 + e^z) as ``jax.nn.softplus`` computes it (logaddexp(z, 0))."""
    return torch.logaddexp(z, torch.zeros_like(z))


@dataclasses.dataclass(frozen=True)
class LogRegProblem:
    A: torch.Tensor  # (n_workers, m, d)
    b: torch.Tensor  # (n_workers, m) in {-1, +1}
    lam: float

    @classmethod
    def from_arrays(cls, A, b, *, lam: float, device="cpu") -> "LogRegProblem":
        """From float32 arrays (numpy, or anything ``np.asarray`` takes)."""
        def f32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(device)

        return cls(A=f32(A), b=f32(b), lam=lam)

    @property
    def n_workers(self) -> int:
        return self.A.shape[0]

    def full_loss(self, x: torch.Tensor) -> torch.Tensor:
        """The objective at ``x`` (d,) over every worker's rows."""
        logits = torch.einsum("wmd,d->wm", self.A, x) * self.b
        return torch.mean(_softplus(-logits)) + 0.5 * self.lam * torch.sum(x * x)

    def worker_loss(self, params, batch) -> torch.Tensor:
        """One worker's (mini)batch loss: ``params`` is ``{"x": (d,)}``,
        ``batch`` ``{"A": (m', d), "b": (m',)}``."""
        x = params["x"]
        logits = batch["A"] @ x * batch["b"]
        return torch.mean(_softplus(-logits)) + 0.5 * self.lam * torch.sum(x * x)

    def worker_data(self):
        return {"A": self.A, "b": self.b}  # leading worker axis


def make_logreg(generator: torch.Generator, *, n_workers: int = 12, m: int = 128,
                d: int = 300, lam: float = 1e-4, heterogeneity: float = 1.0,
                device=None) -> LogRegProblem:
    """heterogeneity: 0 = iid splits; 1 = per-worker shifted feature means
    (the paper's sort-by-index split analogue). The draws are made on the
    generator's device and the problem placed on ``device`` (default: the
    generator's)."""
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=gdev)

    x_true = normal(d) / float(np.sqrt(d))
    shifts = heterogeneity * normal(n_workers, 1, d)
    A = normal(n_workers, m, d) + shifts
    logits = torch.einsum("wmd,d->wm", A, x_true)
    b = torch.sign(logits + 0.5 * normal(n_workers, m))
    b = torch.where(b == 0, torch.ones_like(b), b)
    return LogRegProblem(A=A.to(device), b=b.to(device), lam=lam)
