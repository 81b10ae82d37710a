"""Encode kernel: fused scale + stochastic/deterministic round + clip → int32.

Port of ``repro/kernels/int_compress.py`` (TPU: ``int_compress_2d``). The
CUDA kernel (``csrc/int_compress.cu``) reads the f32 gradient once and
writes the int32 image once, the whole Int(α∘g) operator of the paper in one
pass; :func:`int_compress_plain` is its plain PyTorch version with the same
signature. :mod:`repro_torch.kernels.ops` dispatches between them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import INT_LIM, int_compress_ref


def clip_limit(bits: int, n_workers: int) -> int:
    """§5.1 clip limit as the kernels see it (single kernel-layer copy; the
    wire layer raises its typed WireRangeError before reaching here)."""
    lim = INT_LIM[bits] // max(n_workers, 1)
    if lim == 0:
        raise ValueError(
            f"int{bits} wire cannot carry a sum over {n_workers} workers "
            "(clip limit degenerates to 0; widen the wire)"
        )
    return lim


def int_compress_cuda(
    x: torch.Tensor,
    alpha: torch.Tensor,
    seed: torch.Tensor,
    *,
    n_workers: int,
    bits: int = 32,
    stochastic: bool = True,
) -> torch.Tensor:
    """Launch the encode kernel on the current stream. ``alpha`` (f32) and
    ``seed`` (int32) are one-element tensors on the card: no host sync."""
    lim = clip_limit(bits, n_workers)
    build.require(x, "x", torch.float32, x.device)
    build.require(alpha, "alpha", torch.float32, x.device)
    build.require(seed, "seed", torch.int32, x.device)
    if alpha.numel() != 1 or seed.numel() != 1:
        raise ValueError("alpha and seed must hold one element each")
    if x.numel() >= 2**32:
        raise ValueError("the PRNG counter is 32-bit: at most 2^32 - 1 elements")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    status = build.library().repro_int_compress(
        x.data_ptr(), out.data_ptr(), alpha.data_ptr(), seed.data_ptr(),
        x.numel(), lim, int(stochastic), build.stream_of(x),
    )
    build.check(status, "int_compress")
    return out


# the plain version: the JAX oracle's arithmetic, same signature
int_compress_plain = int_compress_ref
