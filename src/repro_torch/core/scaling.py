"""Scaling-factor rules for IntSGD (port of ``repro/core/scaling.py``: paper
§4 and Appendix A.1).

Every rule returns α (a scalar, or one scalar per leaf) from replicated
state: no communication is needed to agree on α, which is what makes the
integer all-reduce possible.

  * ``AlphaMovingAvg`` (Alg. 1 / Prop. 2, the paper's default)::

        r_k = β r_{k-1} + (1-β) ||x^k - x^{k-1}||²
        α_k = sqrt(d) / sqrt(2 n r_k / η_k² + ε²)

  * ``AlphaLastStep`` (Prop. 3, β = 0 and ε = 0)::

        α_k = η_k sqrt(d) / (sqrt(2n) ||x^k - x^{k-1}||)

  * ``AlphaBlockwise`` (Alg. 2 / Prop. 4), one α per leaf l::

        α_{k,l} = η_k sqrt(d_l) / sqrt(2 n r_{k,l} + η_k² (d_l/d) ε²)

  * ``AlphaHeuristic`` (Sapio et al. 2021, the SwitchML baseline)::

        α = (2^(nb-1) - 1) / (n · 2^max_exp)

    with max_exp the rounded-up exponent of the largest |coordinate| over
    all workers: a profiling max-reduce (``needs_profiling``).

  * ``AlphaDiana`` (Thm 4, IntDIANA)::

        α_k = η_k sqrt(d) / (sqrt(n) ||x^k - x^{k-1}||)

The state lives on the card and every operation is a float32 tensor op in
the JAX package's order; Python constants that JAX rounds to float32 as weak
scalars (β, d_l/d, ε², 1e-30) are rounded the same way. So the same state
gives the same α bit for bit, and α needs no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _f32(v: float) -> float:
    """A Python double rounded to float32, as JAX rounds a weak scalar."""
    return float(np.float32(v))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """0-d float32 constant on ``like``'s device."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AlphaState:
    """Replicated state carried by the scaling rule across steps."""

    r: Any  # float32 0-d tensor (global rules) or {leaf: 0-d tensor}
    step: torch.Tensor  # int32 scalar


def _zero_state(params, r=None) -> AlphaState:
    device = next(iter(params.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return AlphaState(
        r=zero if r is None else r,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


class AlphaRule:
    """Interface: init() -> state; update(state, dx_stats) -> state;
    alpha(state, eta, n, d) -> α. ``dx_stats`` holds GLOBAL ||Δx||²."""

    needs_profiling: bool = False

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
        return _zero_state(params)

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        r = self.beta * state.r + (1.0 - self.beta) * dx_stats.sq
        return AlphaState(r=r, step=state.step + 1)

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        denom = torch.sqrt(
            2.0 * n_workers * state.r / torch.square(eta) + self.eps**2
        )
        return torch.sqrt(_const(float(d), state.r)) / denom


@dataclasses.dataclass(frozen=True)
class AlphaLastStep(AlphaRule):
    """Prop. 3: α_k = η_k √d / (√(2n) ||Δx||); ε=0, β=0. The state's r is
    the last step's ||Δx||²."""

    def init(self, params) -> AlphaState:
        return _zero_state(params)

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        return AlphaState(r=dx_stats.sq, step=state.step + 1)

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        sqrt_2n = torch.sqrt(_const(2.0 * n_workers, state.r))
        return (
            eta * torch.sqrt(_const(float(d), state.r))
            / (sqrt_2n * torch.sqrt(state.r) + 1e-30)
        )


@dataclasses.dataclass(frozen=True)
class AlphaBlockwise(AlphaRule):
    """Alg. 2: one α per leaf (block = layer tensor),
    α_{k,l} = η_k √d_l / sqrt(2 n r_{k,l} + η_k² (d_l/d) ε²). The state's
    r is ``{leaf: 0-d float32}``, and α is a dict over the same leaves."""

    beta: float = 0.9
    eps: float = 1e-8

    def init(self, params) -> AlphaState:
        r = {
            k: torch.zeros((), dtype=torch.float32, device=p.device)
            for k, p in params.items()
        }
        return _zero_state(params, r)

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        r = {
            k: self.beta * r + (1.0 - self.beta) * dx_stats.leaf_sq[k]
            for k, r in state.r.items()
        }
        return AlphaState(r=r, step=state.step + 1)

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        raise NotImplementedError("use alpha_tree(state, eta, n, dims_tree)")

    def alpha_tree(self, state: AlphaState, eta, n_workers: int, dims_tree, d):
        """{leaf: α_l}. ``dims_tree`` maps each leaf to its size d_l (float)
        and ``d`` is the model's size."""
        eps2 = _f32(self.eps**2)
        e2 = torch.square(eta)

        def per_block(r_l, d_l):
            denom = torch.sqrt(2.0 * n_workers * r_l + e2 * _f32(d_l / d) * eps2)
            return eta * torch.sqrt(_const(d_l, r_l)) / (denom + 1e-30)

        return {k: per_block(r, dims_tree[k]) for k, r in state.r.items()}


@dataclasses.dataclass(frozen=True)
class AlphaHeuristic(AlphaRule):
    """SwitchML / Sapio et al. (2021) profiling rule (a baseline that does
    not converge): α = (2^(nb-1) - 1) / (n · 2^max_exp), max_exp =
    ceil(log2 max_i |v_i|) over the GLOBAL package, so the caller supplies
    the max over workers (``needs_profiling``)."""

    bits: int = 8
    needs_profiling: bool = True

    def init(self, params) -> AlphaState:
        return _zero_state(params)

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        return AlphaState(r=state.r, step=state.step + 1)

    def alpha_from_absmax(self, global_absmax: torch.Tensor, n_workers: int):
        absmax = global_absmax.to(torch.float32)
        max_exp = torch.ceil(torch.log2(torch.maximum(absmax, _const(1e-30, absmax))))
        # a tensor numerator: PyTorch computes `float / tensor` as a
        # reciprocal times the float, which rounds differently
        num = _const(2.0 ** (self.bits - 1) - 1.0, absmax)
        return num / (n_workers * torch.exp2(max_exp))

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        raise NotImplementedError("heuristic rule needs the profiled absmax")


@dataclasses.dataclass(frozen=True)
class AlphaDiana(AlphaRule):
    """Thm 4 rule for IntDIANA: α_k = η √d / (√n ||Δx||); the state's r is
    the last step's ||Δx||²."""

    def init(self, params) -> AlphaState:
        return _zero_state(params)

    def update(self, state: AlphaState, dx_stats) -> AlphaState:
        return AlphaState(r=dx_stats.sq, step=state.step + 1)

    def alpha(self, state: AlphaState, eta, n_workers: int, d: int):
        sqrt_n = torch.sqrt(_const(float(n_workers), state.r))
        return (
            eta * torch.sqrt(_const(float(d), state.r))
            / (sqrt_n * torch.sqrt(state.r) + 1e-30)
        )


def make_alpha_rule(name: str, **kw) -> AlphaRule:
    rules = {
        "moving_avg": AlphaMovingAvg,
        "last_step": AlphaLastStep,
        "blockwise": AlphaBlockwise,
        "heuristic": AlphaHeuristic,
        "diana": AlphaDiana,
    }
    if name not in rules:
        raise ValueError(f"unknown alpha rule {name!r}; options {sorted(rules)}")
    return rules[name](**kw)
