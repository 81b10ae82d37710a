"""Plain PyTorch versions of the hand-written kernels (port of
``repro/kernels/ref.py``, the correctness ground truth).

Each function mirrors its JAX oracle's formulation, including the counter
PRNG, so the CPU tests hold it bit for bit (integer outputs) or to FMA
reassociation (float outputs) against the JAX package, and ``chip_smoke.py``
holds each CUDA kernel against it on the card. The kernel wrappers in
:mod:`repro_torch.kernels.ops` run these for tensors on the CPU.

uint32 arithmetic is carried in int64 and masked with ``0xFFFFFFFF`` (no
uint32 shift or add on the CPU); :func:`wrap_int32` returns to int32 with
two's-complement wrap-around, which is what the n-worker word sum needs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.prng import uniform_from_counter

# largest |v| of a signed `bits`-wide value (2^(bits-1) - 1)
INT_LIM = {4: 7, 8: 127, 16: 32767, 32: 2147483647}
_MASK = 0xFFFFFFFF


_LANE_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32}


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 ``x``, as the
    kernels' IEEE ``sqrtf``. On the CPU it goes through float64 (53 >= 2·24
    + 2 bits, so rounding the float64 root to float32 is exact rounding):
    the CPU's float32 ``torch.sqrt`` is not correctly rounded, and which
    elements it misses changes from process to process. On the card
    ``torch.sqrt`` is IEEE already, and a float64 copy of a leaf would cost
    memory and time."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def wrap_int(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 -> the signed integer ``dtype`` (int8, int16 or int32),
    keeping its low bits (two's complement): what a sum in that lane type
    wraps to."""
    bits = _LANE_BITS[dtype]
    half = 1 << (bits - 1)
    return (((v & ((1 << bits) - 1)) ^ half) - half).to(dtype)


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return wrap_int(v, torch.int32)


def saturate_int32(r: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 rounding toward zero, saturating at the int32 range
    with NaN -> 0: XLA's f32 -> s32 convert and CUDA's ``cvt.rzi.s32.f32``.
    Callers have clipped ``r`` to at most 2^31 in magnitude."""
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return r.to(torch.int64).clamp(-(2**31), 2**31 - 1).to(torch.int32)


def int_compress_ref(
    x: torch.Tensor,
    alpha: torch.Tensor,
    seed: torch.Tensor,
    *,
    n_workers: int,
    bits: int = 32,
    stochastic: bool = True,
) -> torch.Tensor:
    """Int(α∘x), clipped so the n-worker sum fits `bits`, as int32. The
    PRNG counter is the logical flat index."""
    xf = x.reshape(-1).to(torch.float32)
    scaled = xf * alpha.to(torch.float32)
    if stochastic:
        counter = torch.arange(xf.numel(), dtype=torch.int64, device=x.device)
        u = uniform_from_counter(counter, seed)
        lo = torch.floor(scaled)
        r = lo + (u < (scaled - lo)).to(torch.float32)
    else:
        r = torch.round(scaled)  # half to even, as jnp.round
    lim = INT_LIM[bits] // max(n_workers, 1)
    r = torch.clamp(r, -float(lim), float(lim))  # in f32, as jnp.clip
    return saturate_int32(r).reshape(x.shape)


def pack_words_ref(
    ints: torch.Tensor, *, bits: int, n_workers: int
) -> torch.Tensor:
    """Canonical PackedInt word layout in uint32 mul/add arithmetic (not
    shifts, so the kernel is held against an independent formulation):
    word[w] = Σ_j (flat[j·m + w] + lim) · 2^(j·b) mod 2^32, m = ceil(d/k),
    k = 32//bits, the image zero-padded to k·m."""
    k = 32 // bits
    lim = INT_LIM[bits] // max(n_workers, 1)
    flat = ints.reshape(-1).to(torch.int64)
    m = -(-flat.numel() // k)
    pad = flat.new_zeros(k * m - flat.numel())
    chunks = torch.cat([flat, pad]).reshape(k, m)
    word = torch.zeros(m, dtype=torch.int64, device=ints.device)
    for j in range(k):
        field = (chunks[j] + lim) & _MASK
        word = (word + field * 2 ** (j * bits)) & _MASK
    return wrap_int32(word)


def unpack_words_ref(
    words: torch.Tensor, shape, *, bits: int, n_summed: int
) -> torch.Tensor:
    """Inverse of :func:`pack_words_ref` after an n_summed-worker
    wrap-around sum: field j = (word // 2^(j·b)) mod 2^b − n_summed·lim."""
    k = 32 // bits
    lim = INT_LIM[bits] // max(n_summed, 1)
    size = math.prod(int(s) for s in shape)
    u = words.reshape(-1).to(torch.int64) & _MASK
    fields = [
        torch.div(u, 2 ** (j * bits), rounding_mode="floor") % 2**bits
        - n_summed * lim
        for j in range(k)
    ]
    return wrap_int32(torch.stack(fields).reshape(-1)[:size]).reshape(shape)


def _decode(ints: torch.Tensor, inv_nalpha, shift):
    """The fused kernels' decode: g_agg = Σints·inv_nalpha (+ h), in that
    order (a product, then the shift add). ``g_agg`` is the new IntDIANA
    global shift h' = h + mean Q; the update consumes clip·g_agg."""
    g_agg = ints.to(torch.float32) * inv_nalpha
    if shift is not None:
        g_agg = g_agg + shift.to(torch.float32)
    return g_agg


def fused_update_ref(
    int_sum: torch.Tensor,
    param: torch.Tensor,
    mom: torch.Tensor,
    *,
    inv_nalpha: torch.Tensor,
    lr: torch.Tensor,
    mu: torch.Tensor,
    wd: torch.Tensor,
    clip: torch.Tensor | float = 1.0,
    shift: torch.Tensor | None = None,
):
    """Dequantize (+ IntDIANA shift) + global-norm clip + weight decay +
    momentum + SGD step (torch.optim.SGD semantics), one elementwise op per
    rounding: g_agg = Σints·inv_nalpha (+ h); g = clip·g_agg + wd·p;
    m' = μm + g; p' = p − lr·m'. ``clip = 1`` is the JAX oracle's
    clip-free form (1·x is exact). Returns ``(p', m')``, and the new shift
    g_agg as a third output when ``shift`` is given."""
    p32 = param.to(torch.float32)
    g_agg = _decode(int_sum, inv_nalpha, shift)
    g = clip * g_agg + wd * p32
    new_m = mu * mom.to(torch.float32) + g
    new_p = p32 - lr * new_m
    out = (new_p.to(param.dtype), new_m.to(mom.dtype))
    return out if shift is None else (*out, g_agg.to(shift.dtype))


def fused_unpack_update_ref(
    words: torch.Tensor,
    param: torch.Tensor,
    mom: torch.Tensor,
    *,
    bits: int,
    n_summed: int,
    **kw,
):
    """:func:`unpack_words_ref` composed with :func:`fused_update_ref`."""
    int_sum = unpack_words_ref(words, param.shape, bits=bits, n_summed=n_summed)
    return fused_update_ref(int_sum, param, mom, **kw)


def fused_adamw_ref(
    int_sum: torch.Tensor,
    param: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    *,
    inv_nalpha,
    lr,
    b1,
    omb1,
    b2,
    omb2,
    eps,
    wd,
    bc1,
    bc2,
    clip: torch.Tensor | float = 1.0,
    shift: torch.Tensor | None = None,
):
    """Dequantize (+ IntDIANA shift) + bias-corrected AdamW step, in the
    fused kernels' order (``_apply_adamw``), one elementwise op per
    rounding::

        g_agg = Σints·inv_nalpha (+ h);   g = clip·g_agg
        m' = b1·m + omb1·g;               v' = b2·v + (omb2·g)·g
        p' = p − lr·((m'/bc1) / (√(v'/bc2) + eps) + wd·p)

    ``omb1``/``omb2`` are 1−b1 / 1−b2 pre-rounded from the Python floats
    (``optim.base.FUSED_SCALAR_TAIL``); the JAX oracle recomputes them in
    f32, one ULP away. Returns ``(p', mu', nu')``, and the new shift g_agg
    as a fourth output when ``shift`` is given."""
    p32 = param.to(torch.float32)
    g_agg = _decode(int_sum, inv_nalpha, shift)
    g = clip * g_agg
    new_m = b1 * mu.to(torch.float32) + omb1 * g
    new_v = b2 * nu.to(torch.float32) + omb2 * g * g
    step = (new_m / bc1) / (sqrt_rn(new_v / bc2) + eps)
    new_p = p32 - lr * (step + wd * p32)
    out = (new_p.to(param.dtype), new_m.to(mu.dtype), new_v.to(nu.dtype))
    return out if shift is None else (*out, g_agg.to(shift.dtype))


def fused_unpack_adamw_ref(
    words: torch.Tensor,
    param: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    *,
    bits: int,
    n_summed: int,
    **kw,
):
    """:func:`unpack_words_ref` composed with :func:`fused_adamw_ref`."""
    int_sum = unpack_words_ref(words, param.shape, bits=bits, n_summed=n_summed)
    return fused_adamw_ref(int_sum, param, mu, nu, **kw)


def block_norms_ref(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Squared L2 norm of each contiguous row-block of a 2-D tensor, in
    float32; the last block is zero-padded to ``block_rows`` rows."""
    rows = x.shape[0]
    nblocks = (rows + block_rows - 1) // block_rows
    pad = nblocks * block_rows - rows
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, 0, 0, pad))
    return torch.sum(
        torch.square(xf).reshape(nblocks, block_rows, x.shape[1]), dim=(1, 2)
    )
