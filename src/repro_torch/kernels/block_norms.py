"""Block sum-of-squares kernel: Σx² over contiguous chunks of a flat tensor.

Port of ``repro/kernels/block_norms.py`` (TPU: ``block_norms_2d``) as the
JAX package reaches it through ``kernels.ops.sq_norm`` and
``block_sq_norms``: the flat tensor is cut into ``nblocks`` chunks of
:func:`chunk_len` elements each (JAX's rule: ceil(numel/nblocks) rounded up
to a whole (8, 128) tile), the elements past the end count as zero, and
each chunk's Σx² comes back as float32, the elements cast to float32 first.
The CUDA kernel (``csrc/block_norms.cu``) takes float32 or int32 and casts
in registers, so an integer image is never copied to float32; it reduces in
one launch, each CTA keeping four 16-byte loads in flight per thread, the
float64 partials summed by the CTA that draws a chunk's last ticket, with
no float atomics and a partition fixed by (numel, nblocks), so its result
is the same bit for bit on every run and every card.
:func:`block_norms_plain` is its plain PyTorch version with the same
signature (any dtype); :mod:`repro_torch.kernels.ops` dispatches between
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import block_norms_ref

TILE_ELEMS = 8 * 128  # the JAX wrapper's (8, 128) tile: the chunk's granule
TILE_COLS = 128
MAX_CTAS = 1024  # CTAs in all at the largest chunks: one wave, 8 per SM at most
THREADS = 256
MAX_BLOCKS = 65535  # the grid's y extent, and the number of ticket counters
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}


def chunk_len(numel: int, nblocks: int) -> int:
    """Elements per chunk: ceil(numel / nblocks) rounded up to a whole tile,
    as ``repro/kernels/ops.py::block_sq_norms`` pads. With 5000 elements
    and 8 blocks the chunks are 1024 long and blocks 5-7 are empty."""
    if nblocks < 1:
        raise ValueError(f"nblocks must be at least 1, got {nblocks}")
    per = -(-int(numel) // nblocks)
    return -(-per // TILE_ELEMS) * TILE_ELEMS


def stage_one_ctas(numel: int, nblocks: int) -> int:
    """CTAs per chunk: about ``MAX_CTAS`` in all, no more than the chunk's
    groups of four fill. A constant function of (numel, nblocks), never of
    the card's SM count, so the summation order is one too."""
    groups = -(-chunk_len(numel, nblocks) // 4)
    need = -(-groups // THREADS)
    return max(1, min(-(-MAX_CTAS // nblocks), need))


_counters: dict[torch.device, torch.Tensor] = {}


def ticket_counters(device: torch.device) -> torch.Tensor:
    """The kernel's per-chunk ticket counters on ``device``: one int32
    tensor of ``MAX_BLOCKS`` zeros, allocated at first use and cached. The
    kernel leaves every counter 0 when it ends, so no launch clears them."""
    device = torch.device(device)
    if device not in _counters:
        _counters[device] = torch.zeros(MAX_BLOCKS, dtype=torch.int32, device=device)
    return _counters[device]


def block_norms_cuda(x: torch.Tensor, nblocks: int) -> torch.Tensor:
    """Launch the one-pass reduction on the current stream; returns float32
    (nblocks,). ``x``: a contiguous float32 or int32 tensor on the card.

    The launch takes tickets from :func:`ticket_counters`, shared by every
    launch on the device: two streams must not run it at once on the same
    device. The port launches it on the current stream only."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"block_norms: the kernel takes float32 or int32, got {x.dtype}"
        )
    build.require(x, "x", x.dtype, x.device)
    if not 1 <= nblocks <= MAX_BLOCKS:
        raise ValueError(
            f"block_norms: nblocks must be in [1, {MAX_BLOCKS}], got {nblocks}"
        )
    numel = x.numel()
    chunk = chunk_len(numel, nblocks)
    ctas = stage_one_ctas(numel, nblocks)
    out = torch.empty(nblocks, dtype=torch.float32, device=x.device)
    partial = torch.empty(nblocks * ctas if ctas > 1 else 0, dtype=torch.float64,
                          device=x.device)
    status = build.library().repro_block_norms(
        x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(), partial.data_ptr(),
        ticket_counters(x.device).data_ptr(), numel, chunk, nblocks, ctas,
        build.stream_of(x),
    )
    build.check(status, "block_norms")
    return out


def block_norms_plain(x: torch.Tensor, nblocks: int) -> torch.Tensor:
    """The JAX wrapper's arithmetic: flatten, cast to float32, zero-pad to
    ``nblocks`` chunks of :func:`chunk_len`, view as (rows, 128) and sum the
    squares of each chunk's rows (:func:`block_norms_ref`)."""
    flat = x.reshape(-1).to(torch.float32)
    per = chunk_len(flat.numel(), nblocks)
    if per == 0:
        return torch.zeros(nblocks, dtype=torch.float32, device=x.device)
    flat = F.pad(flat, (0, per * nblocks - flat.numel()))
    return block_norms_ref(flat.reshape(-1, TILE_COLS), per // TILE_COLS)
