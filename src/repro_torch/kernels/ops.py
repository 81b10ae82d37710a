"""Dispatching wrappers around the hand-written kernels, with launch counts.

Port of ``repro/kernels/ops.py``. Each wrapper takes tensors of any shape
(the kernels index the flat row-major view; the JAX wrappers' pad-at-end 2-D
views exist only for the TPU's tiling, and pad-at-end is what keeps the
encode's PRNG counter equal to the logical flat index on both).

Dispatch is by the device of the first tensor:

  * on the card the wrapper launches its CUDA kernel, or raises — there is
    no fallback;
  * on the CPU it runs the kernel's plain PyTorch version (the role Pallas
    ``interpret=True`` plays in the JAX package).

``launches`` on each wrapper counts the kernel launches, and only those, so
a run can show that its main path went through the kernels;
``shift_launches`` counts those of them that carried an IntDIANA shift.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import block_norms as _bn
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import int_compress as _ic
from repro_torch.kernels import wire_pack as _wp


class KernelOp:
    """One CUDA kernel behind a device-dispatching call."""

    def __init__(self, name: str, cuda: Callable, plain: Callable, source: str):
        self.name = name
        self.cuda = cuda
        self.plain = plain
        self.source = source  # path of the CUDA source within the package
        self.launches = 0
        self.shift_launches = 0  # of those, launches with an IntDIANA shift

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        if x.device.type == "cuda":
            out = self.cuda(x, *args, **kwargs)
            self.launches += 1
            if kwargs.get("shift") is not None:
                self.shift_launches += 1
            return out
        if x.device.type == "cpu":
            return self.plain(x, *args, **kwargs)
        raise ValueError(f"{self.name}: no kernel for device {x.device}")

    def __repr__(self):
        return f"KernelOp({self.name!r}, launches={self.launches})"


int_compress = KernelOp(
    "int_compress", _ic.int_compress_cuda, _ic.int_compress_plain,
    "csrc/int_compress.cu",
)
pack_words = KernelOp(
    "pack_words", _wp.pack_words_cuda, _wp.pack_words_plain, "csrc/wire_pack.cu",
)
unpack_words = KernelOp(
    "unpack_words", _wp.unpack_words_cuda, _wp.unpack_words_plain,
    "csrc/wire_pack.cu",
)
# the fused decode + update family; each takes an optional ``shift=``
fused_unpack_sgd = KernelOp(
    "fused_unpack_sgd", _fu.fused_unpack_sgd_cuda, _fu.fused_unpack_sgd_plain,
    "csrc/fused_update.cu",
)
fused_unpack_adamw = KernelOp(
    "fused_unpack_adamw", _fu.fused_unpack_adamw_cuda,
    _fu.fused_unpack_adamw_plain, "csrc/fused_update.cu",
)
fused_apply_sgd = KernelOp(
    "fused_apply_sgd", _fu.fused_apply_sgd_cuda, _fu.fused_apply_sgd_plain,
    "csrc/fused_update.cu",
)
fused_apply_adamw = KernelOp(
    "fused_apply_adamw", _fu.fused_apply_adamw_cuda, _fu.fused_apply_adamw_plain,
    "csrc/fused_update.cu",
)

# Σx² per contiguous chunk (float32 or int32 in on the card)
block_norms = KernelOp(
    "block_norms", _bn.block_norms_cuda, _bn.block_norms_plain,
    "csrc/block_norms.cu",
)

KERNELS = (
    int_compress, pack_words, unpack_words, fused_unpack_sgd,
    fused_unpack_adamw, fused_apply_sgd, fused_apply_adamw, block_norms,
)


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """||x||² in float32 (0-d) via the block-norms kernel, one block."""
    return block_norms(x, 1).reshape(())


def block_sq_norms(x: torch.Tensor, nblocks: int) -> torch.Tensor:
    """Squared norms of ``nblocks`` equal contiguous chunks of flat(x),
    chunked as the JAX package's ``block_sq_norms`` chunks them
    (:func:`repro_torch.kernels.block_norms.chunk_len`): trailing chunks
    past the end are 0."""
    return block_norms(x, nblocks)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.shift_launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def shift_launch_counts() -> dict:
    return {k.name: k.shift_launches for k in KERNELS}
