"""WireFormat — the codec between "rounded integers" and the wire.

Port of ``repro/wire/base.py``. The four stages::

    encode : f32 tensor, α, seed ->  clipped integer image (canonical int32)
    pack   : integer image       ->  transport PAYLOAD (≥ 1 integer planes)
    unpack : transported payload ->  summed integer image (int32)
    decode : summed image, α     ->  gradient estimate (1/(nα)) Σ Int(α g_i)

Two transport shapes (``transport``):

* ``"psum"`` (DenseInt, PackedInt): pack returns one summable plane, a bare
  tensor of words, and the wire is an integer all-reduce of it. Psum-safety
  contract: ``unpack(Σ_i pack(ints_i), n) == Σ_i ints_i`` elementwise and
  exactly, for any n images within the §5.1 clip, where the Σ on the left
  is the word sum in the payload's own integer type, wrapping as an
  all-reduce in that type does.
* ``"gather"`` (TopKInt): pack returns a dict of named planes
  (``plane_names``) that are only meaningful together, so no sum may cross
  the wire: the payload is all-gathered and unpack receives every plane
  with a leading worker axis and sums by itself. Gather-safety contract:
  ``unpack(stack_i(pack(ints_i)), n) == Σ_i local_image(ints_i)``, where
  :meth:`WireFormat.local_image` is the image one worker's payload decodes
  to (the identity for psum codecs).

The port's encode always takes the counter-PRNG kernel route (the JAX
package's ``use_kernels=True``): the JAX ``jax.random`` rounding stream of
``use_kernels=False`` has no PyTorch counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import INT_LIM

__all__ = ["WireFormat", "WireRangeError", "WireTransportError", "clip_limit",
           "payload_nbytes"]


class WireRangeError(ValueError):
    """The wire configuration cannot represent the n-worker sum: the §5.1
    clip limit ``(2^(b-1)-1) // n_workers`` degenerates to 0, which would
    silently zero every gradient (e.g. 256 workers on an int8 wire)."""


class WireTransportError(ValueError):
    """The wire's lanes cannot ride the transport: a process group sums
    int8 and int32 lanes only, so ``dense16`` (int16 lanes) is refused
    there in favour of ``packed16``, which costs the same bytes."""


def clip_limit(*, n_workers: int, bits: int) -> int:
    """The §5.1 clip limit: largest |v| such that the n-worker sum fits
    `bits`. Raises :class:`WireRangeError` on the degenerate range."""
    if bits not in INT_LIM:
        raise ValueError(f"unsupported wire width {bits}")
    lim = INT_LIM[bits] // max(n_workers, 1)
    if lim == 0:
        raise WireRangeError(
            f"int{bits} wire cannot carry a sum over {n_workers} workers: "
            f"clip limit (2^{bits - 1}-1)//{n_workers} == 0 would zero every "
            f"gradient. Use a wider wire (bits>={bits * 2}) or fewer workers "
            f"per integer all-reduce group."
        )
    return lim


def payload_nbytes(payload) -> int:
    """Exact bytes of one payload: a tensor, or a dict of planes (nested
    dicts summed over). Reads shapes and dtypes only: no device work."""
    if isinstance(payload, dict):
        return sum(payload_nbytes(v) for v in payload.values())
    return payload.numel() * payload.element_size()


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Base codec: shared encode/decode; transport stages per format.
    ``transport`` names the collective the payload rides ("psum" or
    "gather"), ``plane_names`` its planes, ``fused_capable`` whether the
    codec has a fused decode + update kernel."""

    name: ClassVar[str] = "base"
    transport: ClassVar[str] = "psum"
    plane_names: ClassVar[Tuple[str, ...]] = ("words",)
    fused_capable: ClassVar[bool] = True

    bits: int = 32

    def clip_limit(self, n_workers: int) -> int:
        """§5.1 limit; raises WireRangeError when it degenerates to 0."""
        return clip_limit(n_workers=n_workers, bits=self.bits)

    def encode(
        self,
        x: torch.Tensor,
        alpha: torch.Tensor,
        seed: torch.Tensor,
        *,
        n_workers: int,
        stochastic: bool = True,
        amax: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """x -> Int(α ∘ x) clipped for the n-worker sum, canonical int32.
        The kernel reads float32 or bf16 (a bf16 gradient goes in as is and
        is widened exactly inside it, so the integers are those of JAX's
        wrapper, which casts outside its kernel); any other float type is
        cast to float32 first, as the JAX wrapper casts it. ``amax`` (a
        float32 scalar), if given, is raised to the image's largest |value|
        in the same pass."""
        self.clip_limit(n_workers)  # typed error before the kernel's
        if x.dtype not in (torch.float32, torch.bfloat16):
            x = x.to(torch.float32)
        return ops.int_compress(
            x, alpha, seed, n_workers=n_workers, bits=self.bits, stochastic=stochastic,
            amax=amax,
        )

    def decode(
        self, ints: torch.Tensor, alpha: torch.Tensor, *, n_workers: int
    ) -> torch.Tensor:
        """Summed integer image -> gradient estimate (1/(nα)) Σ Int(α g_i)."""
        return ints.to(torch.float32) / (n_workers * alpha)

    def pack(self, ints: torch.Tensor, *, n_workers: int):
        """Integer image -> transport payload: summable words (psum codecs)
        or a dict of ``plane_names`` planes (gather codecs), every plane of
        one codec in one integer type."""
        raise NotImplementedError

    def unpack(
        self, words, shape: Tuple[int, ...], *, n_summed: int
    ) -> torch.Tensor:
        """Transported payload -> summed int32 image: the all-reduced words
        of ``n_summed`` contributions (psum codecs), or ``n_summed`` workers'
        planes stacked on a leading axis, summed here (gather codecs)."""
        raise NotImplementedError

    def local_image(self, ints: torch.Tensor, *, n_workers: int) -> torch.Tensor:
        """The integer image the decoder attributes to this worker's own
        payload: the identity for lossless (psum) codecs; sparse codecs
        return the image masked to what pack selects, which is what an
        error-feedback residual subtracts."""
        return ints

    def wire_bytes(self, size: int) -> int:
        """Exact bytes one worker's `size`-coordinate payload puts on the
        collective, summed over its planes."""
        raise NotImplementedError

    def fused_update(
        self,
        words: torch.Tensor,
        param: torch.Tensor,
        opt: Tuple[torch.Tensor, ...],
        scalars: torch.Tensor,
        *,
        kernel: str,
        n_summed: int,
        shift: torch.Tensor | None = None,
    ):
        """Fused decode + optimizer step straight off the summed transport
        words. ``kernel`` is ``Optimizer.fused_kernel``, ``opt`` that
        kernel's per-leaf f32 state in ``optim.base.FUSED_STATE_TENSORS``
        order, ``scalars`` ``[inv_nalpha, clip, *FUSED_SCALAR_TAIL[kernel]]``
        on the card. Returns ``(new_param, new_opt, new_shift | None)``."""
        raise NotImplementedError

    @staticmethod
    def fused_result(out, opt, shift):
        """A fused kernel's ``(p', *state', [h'])`` -> ``(p', state',
        h' | None)``."""
        return out[0], tuple(out[1:1 + len(opt)]), (out[-1] if shift is not None else None)
