"""DenseInt — one native integer lane per coordinate.

Port of ``repro/wire/dense.py``. pack is a narrowing cast to the narrowest
native lane holding one `bits`-wide value (int8 for bits <= 8, int16,
int32); the §5.1 clip makes the n-worker all-reduce overflow-safe in that
lane type, so unpack is the widening cast back to int32. The word sum keeps
the lane type (:func:`repro_torch.parallel.collectives.add_wire_words`), as
the JAX package's psum of int8 lanes is int8. The fused update reads the
summed lanes directly (``ops.fused_apply_*``): no pack or unpack kernel on
this codec.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.wire.base import WireFormat

# narrowest native lane holding one `bits`-wide value
_LANE = {4: torch.int8, 8: torch.int8, 16: torch.int16, 32: torch.int32}
_FUSED = {"sgd": ops.fused_apply_sgd, "adamw": ops.fused_apply_adamw}


@dataclasses.dataclass(frozen=True)
class DenseInt(WireFormat):
    name: ClassVar[str] = "dense"

    def __post_init__(self):
        if self.bits not in _LANE:
            raise ValueError(
                f"DenseInt lanes carry {sorted(_LANE)}-bit values, got {self.bits}"
            )

    @property
    def lane_dtype(self) -> torch.dtype:
        return _LANE[self.bits]

    def pack(self, ints: torch.Tensor, *, n_workers: int) -> torch.Tensor:
        # the clip in encode() already guarantees the n-worker sum fits the
        # lane, so the narrowing cast is exact
        return ints.to(self.lane_dtype)

    def unpack(
        self, words: torch.Tensor, shape: Tuple[int, ...], *, n_summed: int
    ) -> torch.Tensor:
        return words.to(torch.int32).reshape(shape)

    def wire_bytes(self, size: int) -> int:
        return int(size) * self.lane_dtype.itemsize

    def fused_update(self, words, param, opt, scalars, *, kernel: str,
                     n_summed: int, shift=None):
        out = _FUSED[kernel](words, param, *opt, scalars, shift=shift)
        return self.fused_result(out, opt, shift)
