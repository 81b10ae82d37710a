"""Fused dequantize + momentum-SGD step straight off PackedInt words.

Port of the SGD body of ``repro/kernels/fused_update.py`` (TPU:
``fused_unpack_apply_2d`` with ``_unpack_sgd_kernel``, no IntDIANA shift).
One pass per leaf: the CUDA kernel (``csrc/fused_update.cu``) reads each
transport word once, unpacks its k fields in registers and replaces the chain
decode → clip → weight decay → momentum → step, so the summed integer image
never touches device memory on this route.

Scalar vector (f32, one per leaf, on the card): ``[inv_nalpha, clip, lr,
mu, wd]`` — ``optim.base.FUSED_SCALAR_TAIL["sgd"]`` after the per-leaf
header. The AdamW body, the shift variant and the dense-lane kernel
(``fused_apply_2d``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int_compress import clip_limit
from repro_torch.kernels.ref import fused_unpack_update_ref
from repro_torch.kernels.wire_pack import words_len

PACKED_BITS = (4, 8, 16)


def _check(words, param, mom, scalars, bits):
    if bits not in PACKED_BITS:
        raise ValueError(f"packed fields are {PACKED_BITS} bits wide, got {bits}")
    if param.shape != mom.shape:
        raise ValueError(f"param {tuple(param.shape)} vs momentum {tuple(mom.shape)}")
    if words.numel() != words_len(param.numel(), bits):
        raise ValueError(
            f"{words.numel()} words cannot hold {param.numel()} fields of {bits} bits"
        )
    if scalars.numel() != 5:
        raise ValueError("scalars: [inv_nalpha, clip, lr, mu, wd]")


def fused_unpack_sgd_cuda(
    words: torch.Tensor,
    param: torch.Tensor,
    mom: torch.Tensor,
    scalars: torch.Tensor,
    *,
    bits: int,
    n_summed: int,
):
    """Launch the fused kernel; returns fresh (param', mom') tensors."""
    _check(words, param, mom, scalars, bits)
    nlim = n_summed * clip_limit(bits, n_summed)
    dev = words.device
    build.require(words, "words", torch.int32, dev)
    build.require(param, "param", torch.float32, dev)
    build.require(mom, "mom", torch.float32, dev)
    build.require(scalars, "scalars", torch.float32, dev)
    p_out = torch.empty_like(param)
    m_out = torch.empty_like(mom)
    status = build.library().repro_fused_unpack_sgd(
        words.data_ptr(), param.data_ptr(), mom.data_ptr(), scalars.data_ptr(),
        p_out.data_ptr(), m_out.data_ptr(), param.numel(), words.numel(),
        32 // bits, bits, nlim, build.stream_of(words),
    )
    build.check(status, "fused_unpack_sgd")
    return p_out, m_out


def fused_unpack_sgd_plain(
    words: torch.Tensor,
    param: torch.Tensor,
    mom: torch.Tensor,
    scalars: torch.Tensor,
    *,
    bits: int,
    n_summed: int,
):
    """The plain version: unpack, then one elementwise op per rounding."""
    _check(words, param, mom, scalars, bits)
    inv_nalpha, clip, lr, mu, wd = scalars.to(torch.float32).unbind()
    return fused_unpack_update_ref(
        words, param, mom, bits=bits, n_summed=n_summed,
        inv_nalpha=inv_nalpha, lr=lr, mu=mu, wd=wd, clip=clip,
    )
