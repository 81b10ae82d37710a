"""Shared model pieces (port of ``repro/models/common.py`` at tp = 1: every
worker holds the whole model, so the TP collectives and head padding of the
JAX package drop out)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(shape, in_dim: int, *, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    """U(-1/√in_dim, 1/√in_dim), drawn from ``generator`` on ``device``."""
    scale = 1.0 / math.sqrt(max(in_dim, 1))
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.uniform_(-scale, scale, generator=generator)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The mean and the population variance in float32, then (x − mu)·
    rsqrt(var + eps)·w + b in float32, cast to x's type."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (..., T, H, dh); positions: (..., T) integer. The angle table is
    float32, computed in the JAX package's order."""
    dh = x.shape[-1]
    half = dh // 2
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32, device=x.device))
    freqs = torch.exp(
        -log_theta * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token softmax cross entropy (the tp = 1 case of the JAX package's
    parallel CE). logits: (..., V) float32; labels: (...) ids, negative for
    positions without a label. Returns (...)."""
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    # stabilizer only, not a differentiable path
    shifted = logits - torch.amax(logits, dim=-1, keepdim=True).detach()
    sumexp = torch.sum(torch.exp(shifted), dim=-1)
    ok = (labels >= 0) & (labels < v)
    picked = torch.gather(shifted, -1, labels.clamp(0, v - 1)[..., None])[..., 0]
    picked = torch.where(ok, picked, torch.zeros_like(picked))
    return torch.log(sumexp) - picked


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(up.dtype) * up
