"""Wire codecs between rounded integers and the transport (port of
``repro/wire``). See :mod:`repro_torch.wire.base` for the contract.

Registry names: ``dense4`` / ``dense8`` / ``dense16`` / ``dense32`` (one
native integer lane per coordinate) and ``packed4`` / ``packed8`` /
``packed16`` (bit-packed int32 transport words). The JAX package's other
codecs (``topk*:<k>``, ``logged:<name>``) are not ported yet: any other
name raises saying so.
"""
from __future__ import annotations

from repro_torch.wire.base import WireFormat, WireRangeError, WireTransportError, clip_limit
from repro_torch.wire.dense import DenseInt
from repro_torch.wire.packed import PackedInt

__all__ = [
    "WireFormat",
    "WireRangeError",
    "WireTransportError",
    "DenseInt",
    "PackedInt",
    "clip_limit",
    "make_wire_format",
    "wire_format_names",
    "WIRE_FORMATS",
]

WIRE_FORMATS = {
    "dense4": lambda: DenseInt(bits=4),
    "dense8": lambda: DenseInt(bits=8),
    "dense16": lambda: DenseInt(bits=16),
    "dense32": lambda: DenseInt(bits=32),
    "packed4": lambda: PackedInt(bits=4),
    "packed8": lambda: PackedInt(bits=8),
    "packed16": lambda: PackedInt(bits=16),
}


def wire_format_names():
    return sorted(WIRE_FORMATS)


def make_wire_format(name):
    """Resolve a codec spec (registry name or WireFormat instance)."""
    if not isinstance(name, str):
        return name
    if name not in WIRE_FORMATS:
        raise ValueError(
            f"wire codec {name!r} is not ported yet; the port has "
            f"{wire_format_names()}"
        )
    return WIRE_FORMATS[name]()
