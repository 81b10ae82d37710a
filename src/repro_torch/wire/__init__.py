"""Wire codecs between rounded integers and the transport (port of
``repro/wire``). See :mod:`repro_torch.wire.base` for the contract (psum-
and gather-shaped payloads).

Registry names, as in the JAX package::

    dense4 / dense8 / dense16 / dense32 — one native lane per coordinate
    packed4 / packed8 / packed16        — bit-packed int32 transport words
    topk8:<k> / topk16:<k>              — top-k values + index plane (gather)
    logged:<name>                       — byte-metering wrapper around <name>
"""
from __future__ import annotations

from repro_torch.wire.base import (
    WireFormat, WireRangeError, WireTransportError, clip_limit, payload_nbytes,
)
from repro_torch.wire.dense import DenseInt
from repro_torch.wire.logged import Logged
from repro_torch.wire.packed import PackedInt
from repro_torch.wire.topk import TopKInt

__all__ = [
    "WireFormat",
    "WireRangeError",
    "WireTransportError",
    "DenseInt",
    "PackedInt",
    "TopKInt",
    "Logged",
    "clip_limit",
    "payload_nbytes",
    "make_wire_format",
    "wire_format_names",
    "WIRE_FORMATS",
    "PARAMETRIC_WIRE_FORMATS",
]

# fixed names map to zero-argument factories, parametric ones (a ":<k>"
# suffix) to integer-argument factories
WIRE_FORMATS = {
    "dense4": lambda: DenseInt(bits=4),
    "dense8": lambda: DenseInt(bits=8),
    "dense16": lambda: DenseInt(bits=16),
    "dense32": lambda: DenseInt(bits=32),
    "packed4": lambda: PackedInt(bits=4),
    "packed8": lambda: PackedInt(bits=8),
    "packed16": lambda: PackedInt(bits=16),
}

PARAMETRIC_WIRE_FORMATS = {
    "topk8": lambda k: TopKInt(bits=8, k=k),
    "topk16": lambda k: TopKInt(bits=16, k=k),
}


def wire_format_names():
    """Every accepted codec name, parametric ones with their suffix."""
    return sorted(WIRE_FORMATS) + sorted(f"{p}:<k>" for p in PARAMETRIC_WIRE_FORMATS)


def make_wire_format(name):
    """Resolve a codec spec (registry name or WireFormat instance)."""
    if not isinstance(name, str):
        return name
    if name.startswith("logged:"):
        return Logged(make_wire_format(name[len("logged:"):]))
    if name in WIRE_FORMATS:
        return WIRE_FORMATS[name]()
    prefix, sep, arg = name.partition(":")
    if sep and prefix in PARAMETRIC_WIRE_FORMATS:
        try:
            k = int(arg)
        except ValueError:
            raise ValueError(
                f"unknown wire format {name!r}: {prefix}:<k> needs an integer k, "
                f"got {arg!r}"
            ) from None
        return PARAMETRIC_WIRE_FORMATS[prefix](k)
    raise ValueError(f"unknown wire format {name!r}; options {wire_format_names()}")
