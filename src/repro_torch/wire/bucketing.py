"""Bucketing — fixed-size transport-word buckets for the bucketed wire
(port of ``repro/wire/bucketing.py``).

The bucketed route's unit of communication is a BUCKET: a fixed-size
contiguous run of transport words cut from the concatenation of every
payload plane, in leaf order. The integer all-reduce (or, on a gather wire,
the all-gather) is then issued as several independent collectives instead
of one per leaf, each async, so the transfers queue behind one another
while the step goes on.

A payload tree maps each leaf name to its transport words (a psum codec's
one plane, labelled "words") or to a dict of named planes (a gather codec's
``{"idx": ..., "vals": ...}``); the manifest's ``leaf_planes`` records
which plane each flattened entry is. The mapping is purely structural and
exactly invertible::

    bucketize            : payload tree -> [bucket_0, ..., bucket_{B-1}]
                           (1-D, ``bucket_words`` each, ragged tail)
    debucketize          : buckets      -> payload tree          (bit-exact)
    debucketize_gathered : gathered (n, s) buckets -> payload tree with a
                           leading worker axis on every plane    (bit-exact)

with the :class:`BucketManifest` recording how to invert. No value changes:
the bucketed route transports exactly the words of the serial route (zero
byte inflation), and its sums are bit-identical because integer addition is
exact in any order. Every plane of one codec shares one transport dtype
(int32 words for PackedInt and both TopKInt planes, one dense lane type),
which makes the cross-leaf concatenation legal; a mixed-dtype tree raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["DEFAULT_BUCKET_WORDS", "BucketManifest", "plan_buckets", "bucketize",
           "debucketize", "debucketize_gathered"]

DEFAULT_BUCKET_WORDS = 1 << 16  # 256 KiB of int32 words per bucket

Tree = Dict[str, torch.Tensor]


def _entries(words) -> List[Tuple[Tuple[str, Optional[str]], torch.Tensor]]:
    """The payload's planes in order: ((leaf, plane key or None for a bare
    word plane), tensor)."""
    out = []
    for name, v in words.items():
        if isinstance(v, dict):
            out.extend(((name, plane), t) for plane, t in v.items())
        else:
            out.append(((name, None), v))
    return out


@dataclasses.dataclass(frozen=True)
class BucketManifest:
    """Static inversion record for one (payload tree, bucket_words)
    pairing: each plane's (leaf, plane key) in the tree's order with its
    shape and size, the transport dtype, and each bucket's word count (all
    ``bucket_words`` but possibly the ragged last)."""

    keys: Tuple[Tuple[str, Optional[str]], ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_sizes: Tuple[int, ...]
    dtype: torch.dtype
    bucket_sizes: Tuple[int, ...]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.keys)

    @property
    def leaf_planes(self) -> Tuple[str, ...]:
        """The plane label of each flattened entry: its key in a gather
        codec's plane dict, "words" for a psum codec's one plane."""
        return tuple("words" if plane is None else plane for _, plane in self.keys)

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def total_words(self) -> int:
        return sum(self.bucket_sizes)

    @property
    def payload_bytes(self) -> int:
        """Exact bytes of one worker's bucketed payload: the serial
        route's (bucketing adds no padding)."""
        return self.total_words * self.dtype.itemsize

    def _tree(self, leaves) -> dict:
        out = {}
        for (name, plane), v in zip(self.keys, leaves):
            if plane is None:
                out[name] = v
            else:
                out.setdefault(name, {})[plane] = v
        return out


def plan_buckets(words, *, bucket_words: int = DEFAULT_BUCKET_WORDS) -> BucketManifest:
    if bucket_words <= 0:
        raise ValueError(f"bucket_words must be positive, got {bucket_words}")
    entries = _entries(words)
    if not entries:
        raise ValueError("cannot bucket an empty transport tree")
    dtypes = {v.dtype for _, v in entries}
    if len(dtypes) != 1:
        raise ValueError(
            f"bucketing needs one transport dtype across all leaves, got "
            f"{sorted(str(d) for d in dtypes)} — one wire codec per tree"
        )
    sizes = tuple(v.numel() for _, v in entries)
    full, tail = divmod(sum(sizes), bucket_words)
    return BucketManifest(
        keys=tuple(key for key, _ in entries),
        leaf_shapes=tuple(tuple(v.shape) for _, v in entries),
        leaf_sizes=sizes,
        dtype=dtypes.pop(),
        bucket_sizes=(bucket_words,) * full + ((tail,) if tail else ()),
    )


def bucketize(words, manifest: BucketManifest) -> List[torch.Tensor]:
    """payload tree -> list of 1-D buckets (fixed size, ragged tail): views
    of one concatenated copy of the payload."""
    entries = _entries(words)
    if tuple(key for key, _ in entries) != manifest.keys:
        raise ValueError("the words tree does not match the bucket manifest")
    flat = torch.cat([v.reshape(-1) for _, v in entries])
    return list(torch.split(flat, manifest.bucket_sizes))


def debucketize(buckets: List[torch.Tensor], manifest: BucketManifest):
    """Exact inverse of :func:`bucketize` (same words, same tree): each
    plane a contiguous view of the concatenated buckets."""
    if len(buckets) != manifest.n_buckets:
        raise ValueError(
            f"manifest expects {manifest.n_buckets} buckets, got {len(buckets)}"
        )
    flat = torch.cat([b.reshape(-1) for b in buckets])
    leaves = torch.split(flat, manifest.leaf_sizes)
    return manifest._tree(v.reshape(s) for v, s in zip(leaves, manifest.leaf_shapes))


def debucketize_gathered(buckets: List[torch.Tensor], manifest: BucketManifest):
    """Invert :func:`bucketize` on GATHERED buckets, each ``(n_workers,
    bucket_size)``: the payload tree with a leading worker axis on every
    plane (what a gather codec's unpack takes). Per worker row this is
    :func:`debucketize`; no value changes."""
    if len(buckets) != manifest.n_buckets:
        raise ValueError(
            f"manifest expects {manifest.n_buckets} buckets, got {len(buckets)}"
        )
    n = int(buckets[0].shape[0])
    flat = torch.cat([b.reshape(n, -1) for b in buckets], dim=1)
    leaves = torch.split(flat, manifest.leaf_sizes, dim=1)
    return manifest._tree(v.reshape((n, *s)) for v, s in zip(leaves, manifest.leaf_shapes))
