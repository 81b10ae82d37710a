"""Encode kernel: fused scale + stochastic/deterministic round + clip → int32.

Port of ``repro/kernels/int_compress.py`` (TPU: ``int_compress_2d``). The
CUDA kernel (``csrc/int_compress.cu``) reads the gradient once, float32 or
bf16 (the bf16-param step's gradient, widened exactly in the kernel), and
writes the int32 image once, the whole Int(α∘g) operator of the paper in one
pass; :func:`int_compress_plain` is its plain PyTorch version with the same
signature, which casts the input to float32 first, as the JAX wrapper does.
:mod:`repro_torch.kernels.ops` dispatches between them.

Given ``amax`` (a float32 scalar on the input's device) both also raise it
to the image's largest |value|: the train step's max_local_int, read off
the values the kernel already holds in registers, where the JAX package
reads the image again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import INT_LIM, int_compress_ref

# the inputs the kernel reads, and the C entry point of each
ENTRY = {torch.float32: "repro_int_compress", torch.bfloat16: "repro_int_compress_bf16"}


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


def _check_input(x: torch.Tensor, amax) -> None:
    if x.dtype not in ENTRY:
        raise ValueError(f"the encode kernel reads float32 or bfloat16, got {x.dtype}")
    if amax is not None:
        build.require(amax, "amax", torch.float32, x.device)
        if amax.numel() != 1:
            raise ValueError("amax must hold one element")


def int_compress_cuda(
    x: torch.Tensor,
    alpha: torch.Tensor,
    seed: torch.Tensor,
    *,
    n_workers: int,
    bits: int = 32,
    stochastic: bool = True,
    amax: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the encode kernel on the current stream. ``x`` is float32 or
    bf16; ``alpha`` (f32) and ``seed`` (int32) are one-element tensors on
    the card: no host sync. ``amax``, if given, is raised to the image's
    largest |value|."""
    lim = clip_limit(bits, n_workers)
    _check_input(x, amax)
    build.require(x, "x", x.dtype, x.device)
    build.require(alpha, "alpha", torch.float32, x.device)
    build.require(seed, "seed", torch.int32, x.device)
    if alpha.numel() != 1 or seed.numel() != 1:
        raise ValueError("alpha and seed must hold one element each")
    if x.numel() >= 2**32:
        raise ValueError("the PRNG counter is 32-bit: at most 2^32 - 1 elements")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    status = getattr(build.library(), ENTRY[x.dtype])(
        x.data_ptr(), out.data_ptr(), alpha.data_ptr(), seed.data_ptr(),
        x.numel(), lim, int(stochastic), None if amax is None else amax.data_ptr(),
        build.stream_of(x),
    )
    build.check(status, "int_compress")
    return out


def int_compress_plain(x: torch.Tensor, alpha, seed, *, n_workers: int, bits: int = 32,
                       stochastic: bool = True,
                       amax: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: the JAX oracle's arithmetic (``x`` cast to
    float32 first), on the inputs the kernel takes."""
    _check_input(x, amax)
    out = int_compress_ref(x, alpha, seed, n_workers=n_workers, bits=bits,
                           stochastic=stochastic)
    if amax is not None and out.numel():
        amax.copy_(torch.maximum(amax, out.to(torch.float32).abs().max()).reshape(amax.shape))
    return out
