"""Logged — a wrapper that meters the exact bytes a codec's payloads put on
(and take off) the collective (port of ``repro/wire/logged.py``).

Every ``pack`` adds its payload's bytes to ``pack_bytes`` and every
``unpack`` the bytes it received to ``unpack_bytes`` (on a gather wire n
workers' planes, so the n× amplification shows), with call counts per
(stage, leaf shape); values pass through untouched. The JAX package meters
once, at trace time; eager PyTorch runs pack and unpack on every step, so
the meter counts as they run and :meth:`Logged.reset` starts a new count
(between steps). It reads shapes and dtypes only (:func:`payload_nbytes`):
no device work, no host sync.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Tuple

from repro_torch.wire.base import WireFormat, payload_nbytes

__all__ = ["Logged"]


class Logged:
    """Byte-metering decorator over a WireFormat (the same duck type)."""

    name = "logged"

    def __init__(self, inner: WireFormat):
        self.inner = inner
        self.reset()

    def reset(self) -> None:
        self.pack_bytes = 0
        self.unpack_bytes = 0
        self.calls = defaultdict(int)  # (stage, shape) -> count

    def report(self) -> dict:
        return {
            "codec": f"logged({self.inner.name}{self.inner.bits})",
            "pack_bytes": self.pack_bytes,
            "unpack_bytes": self.unpack_bytes,
            "calls": dict(self.calls),
        }

    @property
    def bits(self) -> int:
        return self.inner.bits

    @property
    def transport(self) -> str:
        return getattr(self.inner, "transport", "psum")

    @property
    def plane_names(self):
        return getattr(self.inner, "plane_names", ("words",))

    @property
    def fused_capable(self) -> bool:
        return getattr(self.inner, "fused_capable", True)

    @property
    def lane_dtype(self):
        return getattr(self.inner, "lane_dtype", None)

    def clip_limit(self, n_workers: int) -> int:
        return self.inner.clip_limit(n_workers)

    def encode(self, x, alpha, seed, *, n_workers, stochastic=True, amax=None):
        return self.inner.encode(x, alpha, seed, n_workers=n_workers,
                                 stochastic=stochastic, amax=amax)

    def decode(self, ints, alpha, *, n_workers):
        return self.inner.decode(ints, alpha, n_workers=n_workers)

    def pack(self, ints, *, n_workers: int):
        payload = self.inner.pack(ints, n_workers=n_workers)
        self.pack_bytes += payload_nbytes(payload)
        self.calls[("pack", tuple(ints.shape))] += 1
        return payload

    def unpack(self, payload, shape: Tuple[int, ...], *, n_summed: int):
        self.unpack_bytes += payload_nbytes(payload)
        self.calls[("unpack", tuple(shape))] += 1
        return self.inner.unpack(payload, shape, n_summed=n_summed)

    def local_image(self, ints, *, n_workers):
        return self.inner.local_image(ints, n_workers=n_workers)

    def wire_bytes(self, size: int) -> int:
        return self.inner.wire_bytes(size)

    def fused_update(self, words, param, opt, scalars, *, kernel: str, n_summed: int,
                     shift=None):
        return self.inner.fused_update(words, param, opt, scalars, kernel=kernel,
                                       n_summed=n_summed, shift=shift)
