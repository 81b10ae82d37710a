"""Bucketing — fixed-size transport-word buckets for the bucketed wire
(port of the psum half of ``repro/wire/bucketing.py``).

The bucketed route's unit of communication is a BUCKET: a fixed-size
contiguous run of transport words cut from the concatenation of every
leaf's payload, in leaf order. The integer all-reduce is then issued as
several independent collectives instead of one per leaf, each async, so
the transfers queue behind one another while the step goes on.

The mapping is purely structural and exactly invertible::

    bucketize   : payload tree -> [bucket_0, ..., bucket_{B-1}]
                  (1-D, ``bucket_words`` each, ragged tail)
    debucketize : buckets      -> payload tree          (bit-exact)

with the :class:`BucketManifest` recording how to invert. No value changes:
the bucketed route transports exactly the words of the serial route (zero
byte inflation), and its sums are bit-identical because integer addition is
exact in any order. Every plane of one codec shares one transport dtype
(int32 words, or one dense lane type), which makes the cross-leaf
concatenation legal; a mixed-dtype tree raises. The gather half
(``debucketize_gathered``) comes with the sparse wire.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

__all__ = ["DEFAULT_BUCKET_WORDS", "BucketManifest", "plan_buckets", "bucketize",
           "debucketize"]

DEFAULT_BUCKET_WORDS = 1 << 16  # 256 KiB of int32 words per bucket

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BucketManifest:
    """Static inversion record for one (words tree, bucket_words) pairing:
    the leaves' names, shapes and sizes in the tree's order, and each
    bucket's word count (all ``bucket_words`` but possibly the ragged
    last)."""

    names: Tuple[str, ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_sizes: Tuple[int, ...]
    bucket_sizes: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)


def plan_buckets(words: Tree, *, bucket_words: int = DEFAULT_BUCKET_WORDS) -> BucketManifest:
    if bucket_words <= 0:
        raise ValueError(f"bucket_words must be positive, got {bucket_words}")
    if not words:
        raise ValueError("cannot bucket an empty transport tree")
    dtypes = {v.dtype for v in words.values()}
    if len(dtypes) != 1:
        raise ValueError(
            f"bucketing needs one transport dtype across all leaves, got "
            f"{sorted(str(d) for d in dtypes)} — one wire codec per tree"
        )
    sizes = tuple(v.numel() for v in words.values())
    full, tail = divmod(sum(sizes), bucket_words)
    return BucketManifest(
        names=tuple(words),
        leaf_shapes=tuple(tuple(v.shape) for v in words.values()),
        leaf_sizes=sizes,
        bucket_sizes=(bucket_words,) * full + ((tail,) if tail else ()),
    )


def bucketize(words: Tree, manifest: BucketManifest) -> List[torch.Tensor]:
    """words tree -> list of 1-D buckets (fixed size, ragged tail): views
    of one concatenated copy of the payload."""
    if tuple(words) != manifest.names:
        raise ValueError("the words tree does not match the bucket manifest")
    flat = torch.cat([words[k].reshape(-1) for k in manifest.names])
    return list(torch.split(flat, manifest.bucket_sizes))


def debucketize(buckets: List[torch.Tensor], manifest: BucketManifest) -> Tree:
    """Exact inverse of :func:`bucketize` (same words, same tree): each
    leaf a contiguous view of the concatenated buckets."""
    if len(buckets) != manifest.n_buckets:
        raise ValueError(
            f"manifest expects {manifest.n_buckets} buckets, got {len(buckets)}"
        )
    flat = torch.cat([b.reshape(-1) for b in buckets])
    leaves = torch.split(flat, manifest.leaf_sizes)
    return {k: v.reshape(s) for k, v, s in zip(manifest.names, leaves, manifest.leaf_shapes)}
