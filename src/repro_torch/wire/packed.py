"""PackedInt — k sub-words bit-packed into each int32 lane.

Port of ``repro/wire/packed.py``. Layout (shared bit for bit with the JAX
package): the flat image of d elements is zero-padded to k·m, m = ceil(d/k)
words, cut into k chunks, and chunk j rides bit field j of every word::

    word[w] = Σ_j (flat[j·m + w] + lim) << (j·bits)        (mod 2^32)

Guard-bit invariant: each field carries v + lim >= 0 with lim =
clip_limit(n), so the n-worker field sum lies in [0, 2^bits - 2] and never
carries into the next field; the int32 word sum wraps mod 2^32, exact per
field; unpack subtracts the accumulated bias n·lim. Wire cost: 4·ceil(d/k)
bytes per worker.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.wire.base import WireFormat

_ALLOWED_BITS = (4, 8, 16)
_FUSED = {"sgd": ops.fused_unpack_sgd, "adamw": ops.fused_unpack_adamw}


@dataclasses.dataclass(frozen=True)
class PackedInt(WireFormat):
    name: ClassVar[str] = "packed"

    bits: int = 8

    def __post_init__(self):
        if self.bits not in _ALLOWED_BITS:
            raise ValueError(
                f"PackedInt packs sub-int32 fields; bits must be one of "
                f"{_ALLOWED_BITS}, got {self.bits}"
            )

    @property
    def fields(self) -> int:
        """Sub-words per int32 transport word."""
        return 32 // self.bits

    def words_len(self, size: int) -> int:
        return -(-int(size) // self.fields)

    def pack(self, ints: torch.Tensor, *, n_workers: int) -> torch.Tensor:
        self.clip_limit(n_workers)
        return ops.pack_words(ints, bits=self.bits, n_workers=n_workers)

    def unpack(
        self, words: torch.Tensor, shape: Tuple[int, ...], *, n_summed: int
    ) -> torch.Tensor:
        self.clip_limit(n_summed)
        return ops.unpack_words(words, shape, bits=self.bits, n_summed=n_summed)

    def wire_bytes(self, size: int) -> int:
        return 4 * self.words_len(size)

    def fused_update(self, words, param, opt, scalars, *, kernel: str,
                     n_summed: int, shift=None):
        out = _FUSED[kernel](
            words, param, *opt, scalars, shift=shift, bits=self.bits,
            n_summed=n_summed,
        )
        return self.fused_result(out, opt, shift)
