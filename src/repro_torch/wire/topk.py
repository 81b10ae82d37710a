"""TopKInt — sparse integer wire: a top-k value plane and an index plane
(port of ``repro/wire/topk.py``).

Per leaf only the k largest-magnitude integers travel, as two int32 planes::

    vals : k two's-complement `bits`-wide fields packed into int32 words
    idx  : k int32 flat coordinates positioning them

A value means something only next to its index, so nothing may be summed on
the wire: the payload rides the gather transport (``transport =
"gather"``), every worker's planes arrive intact, and :meth:`TopKInt.unpack`
sums by scatter-adding each worker's values at its own indices into a dense
int32 image (integer addition: exact in any order). Consequences, as in the
JAX package:

* the clip does not divide by n: :meth:`TopKInt.clip_limit` is the full
  signed range of the value width; the decode-side sum n·M·lim must fit
  int32 instead;
* value fields are plain two's complement (no guard-bit bias), exact on
  unpack for any clipped value;
* a dead worker's all-zero image selects zeros at indices 0..k-1 and adds
  exactly nothing.

Selection is deterministic (:func:`select_topk`): by |value| descending,
ties to the lower flat index, which is what ``lax.top_k`` does and what
``torch.topk`` on the card does not promise. Every worker, the CPU and the
card, and the error-feedback residual (:meth:`TopKInt.local_image`) agree
on the mask.

The encode is the ``int_compress`` kernel with ``n_workers=1``: its clip
``(2^(bits-1)-1) // 1`` is exactly the full range. (The JAX package's
TopKInt encode rounds through ``jax.random``, whose bits PyTorch does not
reproduce; its kernel route with ``n_workers=1`` is the stream the port
shares bit for bit.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import INT_LIM, wrap_int32
from repro_torch.wire.base import WireFormat

__all__ = ["TopKInt", "select_topk"]

_ALLOWED_BITS = (8, 16)


def select_topk(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int64) of the ``k`` largest entries of the 1-D tensor
    ``a``, ordered by value descending and, among equal values, by index
    ascending — ``lax.top_k``'s order, on any device. The k-th largest value
    t is found first; every entry above t is kept, and the remaining places
    go to the lowest-indexed entries equal to t (a running count)."""
    n = a.numel()
    if k >= n:
        sel = torch.arange(n, device=a.device)
    elif a.device.type == "meta":
        # shapes only (the static audit's recording): the selection holds
        # exactly k indices of ``a`` whatever its values
        sel = torch.topk(a, k, sorted=False).indices
    else:
        t = torch.topk(a, k, sorted=False).values.min()
        gt = a > t
        eq = a == t
        need = k - gt.sum()
        take = eq & (torch.cumsum(eq, 0, dtype=torch.int32) <= need)
        del eq
        sel = torch.nonzero(gt | take).reshape(-1)  # ascending, exactly k
        del gt, take
    order = torch.sort(a[sel], descending=True, stable=True).indices
    return sel[order]


@dataclasses.dataclass(frozen=True)
class TopKInt(WireFormat):
    """Top-k sparse codec: ``k`` survivors per leaf on a gather wire."""

    name: ClassVar[str] = "topk"
    transport: ClassVar[str] = "gather"
    plane_names: ClassVar[Tuple[str, ...]] = ("idx", "vals")
    fused_capable: ClassVar[bool] = False  # no fused scatter-decode kernel

    bits: int = 8
    k: int = 64

    def __post_init__(self):
        if self.bits not in _ALLOWED_BITS:
            raise ValueError(
                f"topk packs {self.bits}-bit values into int32 words; "
                f"supported widths are {_ALLOWED_BITS}"
            )
        if self.k < 1:
            raise ValueError(f"topk needs k >= 1, got {self.k}")

    @property
    def fields(self) -> int:
        """Value fields per int32 word of the vals plane."""
        return 32 // self.bits

    def k_eff(self, size: int) -> int:
        """Survivors for a `size`-coordinate leaf: min(k, size)."""
        return min(self.k, int(size))

    def clip_limit(self, n_workers: int) -> int:
        """The full signed range of the value width: nothing is summed on
        the wire, so nothing divides by n."""
        del n_workers
        return INT_LIM[self.bits]

    def encode(self, x, alpha, seed, *, n_workers, stochastic=True, amax=None):
        """Int(α ∘ x) clipped at the full value range: the encode kernel
        with ``n_workers=1``."""
        del n_workers
        if x.dtype not in (torch.float32, torch.bfloat16):
            x = x.to(torch.float32)
        return ops.int_compress(x, alpha, seed, n_workers=1, bits=self.bits,
                                stochastic=stochastic, amax=amax)

    def _select(self, ints: torch.Tensor):
        """(idx int32, vals int32): the top-k of |value|, ties to the
        lower index."""
        flat = ints.reshape(-1).to(torch.int32)
        idx = select_topk(flat.abs(), self.k_eff(flat.numel()))
        return idx.to(torch.int32), flat[idx]

    def _pack_vals(self, vals: torch.Tensor) -> torch.Tensor:
        """k clipped values -> ceil(k/fields) int32 words; value j·W + w
        (W words) rides field j of word w, plain two's complement."""
        m, b = self.fields, self.bits
        k = vals.numel()
        words_len = -(-k // m)
        padded = torch.zeros(words_len * m, dtype=torch.int64, device=vals.device)
        padded[:k] = vals.to(torch.int64) & ((1 << b) - 1)
        chunks = padded.reshape(m, words_len)
        word = torch.zeros(words_len, dtype=torch.int64, device=vals.device)
        for j in range(m):
            word |= chunks[j] << (j * b)
        return wrap_int32(word)

    def _unpack_vals(self, words: torch.Tensor, k: int) -> torch.Tensor:
        """Inverse of :meth:`_pack_vals` over a leading batch axis: (..., W)
        int32 words -> (..., k) sign-extended int32 values."""
        m, b = self.fields, self.bits
        mask, sign = (1 << b) - 1, 1 << (b - 1)
        w64 = words.to(torch.int64)
        fields = torch.cat([(w64 >> (j * b)) & mask for j in range(m)], dim=-1)
        return ((fields ^ sign) - sign)[..., :k].to(torch.int32)

    def pack(self, ints: torch.Tensor, *, n_workers: int):
        del n_workers  # selection is per worker; nothing sums on the wire
        idx, vals = self._select(ints)
        return {"idx": idx, "vals": self._pack_vals(vals)}

    def unpack(self, payload, shape: Tuple[int, ...], *, n_summed: int) -> torch.Tensor:
        """Gathered payload (planes with a leading ``n_summed`` worker axis)
        -> summed int32 image, by scatter-adding every worker's
        sign-extended values at its own indices."""
        size = int(math.prod(shape)) if shape else 1
        k = self.k_eff(size)
        idx = payload["idx"].reshape(n_summed * k).to(torch.int64)
        words = payload["vals"].reshape(n_summed, -1)
        vals = self._unpack_vals(words, k).reshape(n_summed * k)
        out = torch.zeros(size, dtype=torch.int32, device=vals.device)
        out.index_add_(0, idx, vals)
        return out.reshape(shape)

    def local_image(self, ints: torch.Tensor, *, n_workers: int) -> torch.Tensor:
        """The top-k-masked image this worker's payload decodes to, exactly
        (the packed fields are lossless for clipped values)."""
        del n_workers
        idx, vals = self._select(ints)
        out = torch.zeros(ints.numel(), dtype=torch.int32, device=ints.device)
        out[idx.to(torch.int64)] = vals
        return out.reshape(ints.shape)

    def wire_bytes(self, size: int) -> int:
        k = self.k_eff(size)
        return 4 * (-(-k // self.fields)) + 4 * k

    def fused_update(self, words, param, opt, scalars, *, kernel, n_summed, shift=None):
        raise NotImplementedError(
            "topk has no fused decode+update kernel: the gather payload "
            "(vals + idx planes) needs a scatter-shaped decode the fused "
            "route does not implement (fused_capable is False); "
            "run with fused=False"
        )
