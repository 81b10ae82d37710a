"""Pack / unpack kernels for PackedInt transport words.

Port of ``repro/kernels/wire_pack.py`` (TPU: ``pack_words_2d``,
``unpack_words_2d``). Layout: the flat image of d elements is split into
k = 32/bits chunks of m = ceil(d/k); chunk j rides bit field j of every
word, ``word[w] = Σ_j (flat[j·m + w] + lim) << (j·bits)`` mod 2^32, with
zero image padding (so padded fields carry ``lim``). The CUDA kernels
(``csrc/wire_pack.cu``) index the flat image in place of the Pallas
wrapper's padded chunk-major copy. The plain versions have the kernels'
signatures; :mod:`repro_torch.kernels.ops` dispatches between them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int_compress import clip_limit
from repro_torch.kernels.ref import pack_words_ref, unpack_words_ref


def words_len(size: int, bits: int) -> int:
    return -(-int(size) // (32 // bits))


def pack_words_cuda(ints: torch.Tensor, *, bits: int, n_workers: int) -> torch.Tensor:
    """Bit-pack a clipped int32 image into ceil(d/k) int32 words."""
    lim = clip_limit(bits, n_workers)
    build.require(ints, "ints", torch.int32, ints.device)
    d = ints.numel()
    m = words_len(d, bits)
    words = torch.empty(m, dtype=torch.int32, device=ints.device)
    status = build.library().repro_pack_words(
        ints.data_ptr(), words.data_ptr(), d, m, 32 // bits, bits, lim,
        build.stream_of(ints),
    )
    build.check(status, "pack_words")
    return words


def unpack_words_cuda(
    words: torch.Tensor, shape, *, bits: int, n_summed: int
) -> torch.Tensor:
    """Summed transport words -> summed int32 image of ``shape``."""
    nlim = n_summed * clip_limit(bits, n_summed)
    build.require(words, "words", torch.int32, words.device)
    d = math.prod(int(s) for s in shape)
    m = words.numel()
    if m != words_len(d, bits):
        raise ValueError(f"{m} words cannot hold a {tuple(shape)} image at {bits} bits")
    out = torch.empty(tuple(shape), dtype=torch.int32, device=words.device)
    status = build.library().repro_unpack_words(
        words.data_ptr(), out.data_ptr(), d, m, 32 // bits, bits, nlim,
        build.stream_of(words),
    )
    build.check(status, "unpack_words")
    return out


# the plain versions: the JAX oracles' arithmetic, same signatures
pack_words_plain = pack_words_ref
unpack_words_plain = unpack_words_ref
