"""WireFormat — the codec between "rounded integers" and the wire.

Port of ``repro/wire/base.py`` (psum transport only). The four stages::

    encode : f32 tensor, α, seed ->  clipped integer image (canonical int32)
    pack   : integer image       ->  transport words (one integer plane)
    unpack : summed words        ->  summed integer image (int32)
    decode : summed image, α     ->  gradient estimate (1/(nα)) Σ Int(α g_i)

Psum-safety contract: ``unpack(Σ_i pack(ints_i), n) == Σ_i ints_i``
elementwise and exactly, for any n images within the §5.1 clip, where the Σ
on the left is the word sum in the payload's own integer type, wrapping as an
all-reduce in that type does.

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

__all__ = ["WireFormat", "WireRangeError", "WireTransportError", "clip_limit"]


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


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Base codec: shared encode/decode; transport stages per format."""

    name: ClassVar[str] = "base"
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

    def pack(self, ints: torch.Tensor, *, n_workers: int) -> torch.Tensor:
        """Integer image -> summable transport words."""
        raise NotImplementedError

    def unpack(
        self, words: torch.Tensor, shape: Tuple[int, ...], *, n_summed: int
    ) -> torch.Tensor:
        """All-reduced words of ``n_summed`` contributions -> summed int32
        image."""
        raise NotImplementedError

    def wire_bytes(self, size: int) -> int:
        """Exact bytes one worker's `size`-coordinate payload puts on the
        collective."""
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
