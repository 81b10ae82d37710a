"""Fused dequantize + optimizer step, the whole {SGD, AdamW} × {IntSGD,
IntDIANA shift} × {packed words, dense lanes} family.

Port of ``repro/kernels/fused_update.py`` (TPU: ``fused_unpack_apply_2d``
with ``_unpack_sgd_kernel``/``_unpack_adamw_kernel``, and ``fused_apply_2d``
with ``_sgd_kernel``/``_adamw_kernel``, each with and without
``has_shift``). One pass per leaf: the CUDA kernels
(``csrc/fused_update.cu``) read each transport word (packed) or integer
lane (dense) once and replace the chain decode → clip → (weight decay) →
moments → step, so the summed integer image is never read back on this
route.

Scalar vectors (f32, one per leaf, on the card), the per-leaf header
``[inv_nalpha, clip]`` then ``optim.base.FUSED_SCALAR_TAIL[kernel]``::

    sgd   : [inv_nalpha, clip, lr, mu, wd]
    adamw : [inv_nalpha, clip, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2]

Shift (IntDIANA): with ``shift=h`` the decoded aggregate is
g_agg = Σints·inv_nalpha + h and the kernel also writes g_agg, the new
global shift, before the clip. Each wrapper returns fresh tensors:
``(p', *state')``, then ``h'`` when a shift was given.

The param is float32 or bf16 (the JAX step's default ``param_dtype``):
with a bf16 param the kernels read and write it as bf16 and run the same
float32 arithmetic, p' rounded to nearest even (the ``_bf16`` entry points
of the CUDA source); the state tensors and the shift are float32 either way.
Any other dtype raises: nothing is cast on the way in.

Every function here has a ``*_cuda`` launcher and a ``*_plain`` version of
the same signature; :mod:`repro_torch.kernels.ops` dispatches between them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int_compress import clip_limit
from repro_torch.kernels.ref import (
    fused_adamw_ref, fused_unpack_adamw_ref, fused_unpack_update_ref,
    fused_update_ref,
)
from repro_torch.kernels.wire_pack import words_len

PACKED_BITS = (4, 8, 16)
# the params the kernels update; state, shift and scalars are float32
PARAM_DTYPES = (torch.float32, torch.bfloat16)
# dense integer lanes the kernel reads, and their width in bytes
LANE_BYTES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
SCALARS = {
    "sgd": ("inv_nalpha", "clip", "lr", "mu", "wd"),
    "adamw": ("inv_nalpha", "clip", "lr", "b1", "omb1", "b2", "omb2", "eps",
              "wd", "bc1", "bc2"),
}


def _check_state(param, states, scalars, shift, kernel):
    if param.dtype not in PARAM_DTYPES:
        raise ValueError(f"the fused kernels update float32 or bfloat16 params, got {param.dtype}")
    for s in (*states, *(() if shift is None else (shift,))):
        if s.dtype != torch.float32:
            raise ValueError(f"optimizer state and shift are float32, got {s.dtype}")
    for s in states:
        if s.shape != param.shape:
            raise ValueError(
                f"param {tuple(param.shape)} vs optimizer state {tuple(s.shape)}"
            )
    if shift is not None and shift.shape != param.shape:
        raise ValueError(f"param {tuple(param.shape)} vs shift {tuple(shift.shape)}")
    if scalars.numel() != len(SCALARS[kernel]):
        raise ValueError(f"scalars: [{', '.join(SCALARS[kernel])}]")


def _check_packed(words, param, states, scalars, shift, kernel, bits):
    if bits not in PACKED_BITS:
        raise ValueError(f"packed fields are {PACKED_BITS} bits wide, got {bits}")
    _check_state(param, states, scalars, shift, kernel)
    if words.numel() != words_len(param.numel(), bits):
        raise ValueError(
            f"{words.numel()} words cannot hold {param.numel()} fields of {bits} bits"
        )


def _check_dense(ints, param, states, scalars, shift, kernel):
    if ints.dtype not in LANE_BYTES:
        raise ValueError(f"dense lanes are int8, int16 or int32, got {ints.dtype}")
    _check_state(param, states, scalars, shift, kernel)
    if ints.numel() != param.numel():
        raise ValueError(f"{ints.numel()} lanes for {param.numel()} params")


def _outputs(param, states, scalars, shift):
    """Require what the kernels take and allocate their fresh outputs
    ``[p', *state', (h')]``."""
    dev = param.device
    build.require(param, "param", param.dtype, dev)
    for i, s in enumerate(states):
        build.require(s, f"state {i}", torch.float32, dev)
    build.require(scalars, "scalars", torch.float32, dev)
    outs = [torch.empty_like(param)] + [torch.empty_like(s) for s in states]
    if shift is not None:
        build.require(shift, "shift", torch.float32, dev)
        outs.append(torch.empty_like(shift))
    return outs


def _ptr(t):
    return None if t is None else t.data_ptr()


def _entry(name, param):
    """The C entry point for ``param``'s dtype (``_bf16`` for bf16)."""
    return getattr(build.library(), name + ("_bf16" if param.dtype == torch.bfloat16 else ""))


# ---------------------------------------------------------------------------
# packed words (fused_unpack_apply_2d)
# ---------------------------------------------------------------------------
def _launch_unpack(fn, name, words, param, states, scalars, shift, bits, n_summed):
    nlim = n_summed * clip_limit(bits, n_summed)
    build.require(words, "words", torch.int32, param.device)
    outs = _outputs(param, states, scalars, shift)
    h_out = outs[-1] if shift is not None else None
    status = fn(
        words.data_ptr(), param.data_ptr(), *(s.data_ptr() for s in states),
        _ptr(shift), scalars.data_ptr(),
        *(o.data_ptr() for o in outs[:1 + len(states)]), _ptr(h_out),
        param.numel(), words.numel(), 32 // bits, bits, nlim,
        build.stream_of(words),
    )
    build.check(status, name)
    return tuple(outs)


def fused_unpack_sgd_cuda(words, param, mom, scalars, *, shift=None, bits: int,
                          n_summed: int):
    """Launch the packed SGD kernel: ``(p', m')`` (``+ (h',)`` with shift)."""
    _check_packed(words, param, (mom,), scalars, shift, "sgd", bits)
    return _launch_unpack(
        _entry("repro_fused_unpack_sgd", param), "fused_unpack_sgd", words,
        param, (mom,), scalars, shift, bits, n_summed,
    )


def fused_unpack_sgd_plain(words, param, mom, scalars, *, shift=None,
                           bits: int, n_summed: int):
    """The plain version: unpack, then one elementwise op per rounding."""
    _check_packed(words, param, (mom,), scalars, shift, "sgd", bits)
    inv_nalpha, clip, lr, mu, wd = scalars.to(torch.float32).unbind()
    return fused_unpack_update_ref(
        words, param, mom, bits=bits, n_summed=n_summed,
        inv_nalpha=inv_nalpha, lr=lr, mu=mu, wd=wd, clip=clip, shift=shift,
    )


def fused_unpack_adamw_cuda(words, param, mu, nu, scalars, *, shift=None,
                            bits: int, n_summed: int):
    """Launch the packed AdamW kernel: ``(p', mu', nu')`` (``+ (h',)``)."""
    _check_packed(words, param, (mu, nu), scalars, shift, "adamw", bits)
    return _launch_unpack(
        _entry("repro_fused_unpack_adamw", param), "fused_unpack_adamw", words,
        param, (mu, nu), scalars, shift, bits, n_summed,
    )


def _adamw_kw(scalars):
    return dict(zip(SCALARS["adamw"], scalars.to(torch.float32).unbind()))


def fused_unpack_adamw_plain(words, param, mu, nu, scalars, *, shift=None,
                             bits: int, n_summed: int):
    """The plain version: unpack, then the AdamW arithmetic op by op."""
    _check_packed(words, param, (mu, nu), scalars, shift, "adamw", bits)
    return fused_unpack_adamw_ref(
        words, param, mu, nu, bits=bits, n_summed=n_summed, shift=shift,
        **_adamw_kw(scalars),
    )


# ---------------------------------------------------------------------------
# dense lanes (fused_apply_2d)
# ---------------------------------------------------------------------------
def _launch_apply(fn, name, ints, param, states, scalars, shift):
    build.require(ints, "ints", ints.dtype, param.device)
    outs = _outputs(param, states, scalars, shift)
    h_out = outs[-1] if shift is not None else None
    status = fn(
        ints.data_ptr(), LANE_BYTES[ints.dtype], param.data_ptr(),
        *(s.data_ptr() for s in states), _ptr(shift), scalars.data_ptr(),
        *(o.data_ptr() for o in outs[:1 + len(states)]), _ptr(h_out),
        param.numel(), build.stream_of(ints),
    )
    build.check(status, name)
    return tuple(outs)


def fused_apply_sgd_cuda(ints, param, mom, scalars, *, shift=None):
    """Launch the dense-lane SGD kernel: ``(p', m')`` (``+ (h',)``)."""
    _check_dense(ints, param, (mom,), scalars, shift, "sgd")
    return _launch_apply(
        _entry("repro_fused_apply_sgd", param), "fused_apply_sgd", ints, param,
        (mom,), scalars, shift,
    )


def fused_apply_sgd_plain(ints, param, mom, scalars, *, shift=None):
    """The plain version: widen, then one elementwise op per rounding."""
    _check_dense(ints, param, (mom,), scalars, shift, "sgd")
    inv_nalpha, clip, lr, mu, wd = scalars.to(torch.float32).unbind()
    return fused_update_ref(
        ints.reshape(param.shape), param, mom, inv_nalpha=inv_nalpha, lr=lr,
        mu=mu, wd=wd, clip=clip, shift=shift,
    )


def fused_apply_adamw_cuda(ints, param, mu, nu, scalars, *, shift=None):
    """Launch the dense-lane AdamW kernel: ``(p', mu', nu')`` (``+ (h',)``)."""
    _check_dense(ints, param, (mu, nu), scalars, shift, "adamw")
    return _launch_apply(
        _entry("repro_fused_apply_adamw", param), "fused_apply_adamw", ints,
        param, (mu, nu), scalars, shift,
    )


def fused_apply_adamw_plain(ints, param, mu, nu, scalars, *, shift=None):
    """The plain version: widen, then the AdamW arithmetic op by op."""
    _check_dense(ints, param, (mu, nu), scalars, shift, "adamw")
    return fused_adamw_ref(
        ints.reshape(param.shape), param, mu, nu, shift=shift,
        **_adamw_kw(scalars),
    )
