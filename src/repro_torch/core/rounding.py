"""Randomized and deterministic integer rounding — the paper's Int operator
(port of ``repro/core/rounding.py``).

    Int(t) = floor(t) + 1  with prob  t - floor(t)
             floor(t)      otherwise                       (paper §2)

Properties (Lemma 1): E[Int(t)] = t and E[(Int(t) - t)^2] <= 1/4. The
float-domain quantizer is Q(x) = (1/α) ∘ Int(α ∘ x) (eq. 2); the integer
image Int(α ∘ x) is what crosses the wire.

:func:`stochastic_round` draws its uniforms from an explicit
``torch.Generator``. The JAX package draws them from ``jax.random.uniform``,
whose bits PyTorch does not reproduce, so the two agree in distribution
only. The wire's encode does not use this stream: it takes the counter PRNG
of the encode kernel (:func:`repro_torch.kernels.ops.int_compress`), which
both packages share bit for bit given the same int32 seed.

Overflow safety: local integers are clipped so that the *sum over n
workers* fits the wire type: |Int(α g_i)| <= (2^(b-1)-1)/n (§5.1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import INT_LIM, saturate_int32
from repro_torch.wire.base import WireRangeError, clip_limit

__all__ = [
    "INT_LIM", "WireRangeError", "stochastic_round", "deterministic_round", "int_round",
    "clip_limit", "clip_for_wire", "wire_dtype", "encode", "decode",
]


def stochastic_round(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Randomized rounding to the neighbouring integers, unbiased (float32
    out). ``generator`` lives on ``x``'s device."""
    x = x.to(torch.float32)
    lo = torch.floor(x)
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return lo + (u < x - lo).to(torch.float32)


def deterministic_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (``jnp.round``, ``torch.round``): the IntSGD
    (Determ.) variant."""
    return torch.round(x.to(torch.float32))


def int_round(x: torch.Tensor, generator: torch.Generator | None, *,
              stochastic: bool = True) -> torch.Tensor:
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        return stochastic_round(x, generator)
    return deterministic_round(x)


def clip_for_wire(ints: torch.Tensor, *, n_workers: int, bits: int) -> torch.Tensor:
    """Clip local integers so the n-worker sum fits the wire type (§5.1),
    in ``ints``' own type (a float image clips against the limit rounded to
    float32, as ``jnp.clip`` does)."""
    lim = clip_limit(n_workers=n_workers, bits=bits)
    return torch.clamp(ints, -lim, lim)


def wire_dtype(bits: int) -> torch.dtype:
    """Narrowest native integer lane that holds one `bits`-wide value."""
    return {4: torch.int8, 8: torch.int8, 16: torch.int16, 32: torch.int32}[bits]


def encode(x: torch.Tensor, alpha, generator: torch.Generator | None, *, n_workers: int,
           bits: int = 32, stochastic: bool = True) -> torch.Tensor:
    """x -> Int(α ∘ x), clipped to the wire range, in the narrowest lane
    that holds one `bits`-wide value (:func:`wire_dtype`): the reference
    scalar-lane transport. The float -> integer conversion saturates and maps
    NaN to 0, as XLA's does at the int32 edge."""
    r = int_round(x.to(torch.float32) * alpha, generator, stochastic=stochastic)
    r = clip_for_wire(r, n_workers=n_workers, bits=bits)
    return saturate_int32(r).to(wire_dtype(bits))


def decode(ints: torch.Tensor, alpha, *, n_workers: int) -> torch.Tensor:
    """Aggregated integers -> gradient estimate (1/(n α)) ∘ Σ_i Int(α g_i)."""
    return ints.to(torch.float32) / (n_workers * alpha)
