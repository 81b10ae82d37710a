"""Counter-based PRNG shared by the encode kernel and its plain versions.

Port of ``repro/kernels/prng.py``: the MurmurHash3 fmix32 finalizer over
``counter * 0x9E3779B9 + seed``, with the top 24 bits scaled to [0, 1). The
CUDA kernel computes it in ``uint32_t``; PyTorch on the CPU has no uint32
shift or add, so this version carries each 32-bit value in int64 and masks
with ``0xFFFFFFFF``. Products are split into 16-bit halves, so no
intermediate leaves the int64 range and the result is exact on any device.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant c."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer on int64-carried uint32 values."""
    x = x & _MASK
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    return x ^ (x >> 16)


def uniform_from_counter(counter: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """U[0, 1) float32 from an integer counter and an int32 seed (the seed's
    two's-complement bits are its uint32 value, as in ``astype(uint32)``)."""
    s = seed.to(torch.int64) & _MASK
    h = fmix32((mul32(counter.to(torch.int64) & _MASK, _GOLDEN) + s) & _MASK)
    return (h >> 8).to(torch.float32) * 2.0**-24
