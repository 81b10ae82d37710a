"""Scaling-factor rules for IntSGD (port of ``repro/core/scaling.py``: the
paper's default rule and IntDIANA's).

``AlphaMovingAvg`` (Alg. 1 / Prop. 2)::

    r_k = β r_{k-1} + (1-β) ||x^k - x^{k-1}||²
    α_k = sqrt(d) / sqrt(2 n r_k / η_k² + ε²)

α comes from replicated state: no communication is needed to agree on it,
which is what makes the integer all-reduce possible. The state lives on the
card and every operation is a float32 tensor op in the JAX package's order,
so α matches it bit for bit from the same state and needs no host sync.

``AlphaDiana`` (Thm 4, IntDIANA)::

    α_k = η_k sqrt(d) / (sqrt(n) ||x^k - x^{k-1}||)

The last-step, blockwise and heuristic rules are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AlphaState:
    """Replicated state carried by the scaling rule across steps."""

    r: torch.Tensor  # float32 scalar
    step: torch.Tensor  # int32 scalar


class AlphaRule:
    """Interface: init() -> state; update(state, dx_stats) -> state;
    alpha(state, eta, n, d) -> α. ``dx_stats`` holds GLOBAL ||Δx||²."""

    def init(self, params) -> AlphaState:
        raise NotImplementedError

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        raise NotImplementedError

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AlphaMovingAvg(AlphaRule):
    """Paper default: β=0.9, ε=1e-8 (Alg. 1)."""

    beta: float = 0.9
    eps: float = 1e-8

    def init(self, params) -> AlphaState:
        device = next(iter(params.values())).device
        return AlphaState(
            r=torch.zeros((), dtype=torch.float32, device=device),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        r = self.beta * state.r + (1.0 - self.beta) * dx_stats.sq
        return AlphaState(r=r, step=state.step + 1)

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        denom = torch.sqrt(
            2.0 * n_workers * state.r / torch.square(eta) + self.eps**2
        )
        d32 = torch.full((), float(d), dtype=torch.float32, device=state.r.device)
        return torch.sqrt(d32) / denom


@dataclasses.dataclass(frozen=True)
class AlphaDiana(AlphaRule):
    """Thm 4 rule for IntDIANA: α_k = η √d / (√n ||Δx||); the state's r is
    the last step's ||Δx||²."""

    def init(self, params) -> AlphaState:
        device = next(iter(params.values())).device
        return AlphaState(
            r=torch.zeros((), dtype=torch.float32, device=device),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        return AlphaState(r=dx_stats.sq, step=state.step + 1)

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        dev = state.r.device
        d32 = torch.full((), float(d), dtype=torch.float32, device=dev)
        sqrt_n = torch.sqrt(torch.full((), float(n_workers), dtype=torch.float32, device=dev))
        return eta * torch.sqrt(d32) / (sqrt_n * torch.sqrt(state.r) + 1e-30)
