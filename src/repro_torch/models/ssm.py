"""Mamba2 (SSD) block (port of ``repro/models/ssm.py``): the train path
(``_causal_conv``, ``_ssd_chunk``, ``mamba2_train``), at tp > 1 on the
rank's heads of a model axis, and the one-token decode with its O(1)
state (``init_mamba2_cache``, ``mamba2_decode``), at tp > 1 the same way.

Tensor parallelism, as in the JAX package: the heads (d_inner) are
sharded over the model axis, ``w_bc`` is replicated, and the out
projection is row-parallel (``axes.psum_tp``). Each rank's ``w_xz`` is its
contiguous slice of the global ``[x | z]`` columns, split in half again
locally, and the gate's RMSNorm takes the mean over the rank's own
``d_inner/tp``; both are the reference's behaviour, which the port keeps
(at tp = 2 rank 0's local x and z are both global x columns).

State space:  h_t = exp(A·dt_t) h_{t-1} + dt_t · (B_t ⊗ x_t),   y_t = C_t · h_t
with scalar A<0 per head, shared B/C projections (ngroups=1), per-head dt.
The depthwise conv is applied to x only and the gate's norm is one RMSNorm
over d_inner, as in the JAX package.

The JAX package computes the SSD in plain XLA code, not a Pallas kernel:
an intra-chunk quadratic form and a ``lax.scan`` of the state over chunks
of 256, in float32, each chunk under ``jax.checkpoint``. The port keeps
every element's arithmetic (the same clip of the log-decay differences to
[-60, 0], the same causal mask, float32) but computes the terms that do
not read the carried state — the intra-chunk output, ``exp(s)`` and each
chunk's own state contribution — for all chunks at once; only the carry
``h = exp(s_Q)·h + dh`` runs chunk by chunk (:func:`ssd_states`). The
whole SSD of a layer runs under ``torch.utils.checkpoint``: backward
recomputes it rather than keep its (B, Q, Q, H) float32 temporaries.

The stages (:func:`in_proj`, :func:`_causal_conv`, :func:`ssd_intra`,
:func:`ssd_states`, :func:`ssd_inter`, :func:`gate_norm`) are separate
functions so that each can be timed alone.

The decode step (:func:`mamba2_decode`) keeps the conv's last K - 1
inputs and the (N, P) state of every head, float32, and writes both in
place. It follows the JAX package's types, which differ from train's: the
conv buffer is float32 (``init_mamba2_cache``'s default), so the new
input joins it in float32 and the taps' products and sum are float32
(``jnp.sum`` sums a bf16 product in float32 too, then rounds); the SiLU'd
conv output stays float32 into the state update and the skip term.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import SINGLE, Axes, rmsnorm

CONV_K = 4


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (K, C) depthwise. Products and sums in x's type,
    tap 0 first; SiLU in float32, cast back."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + t, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out.to(torch.float32)).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` defines it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def in_proj(p, x: torch.Tensor):
    """The input projections in x's type: ``(xin, z, bc, dt)`` with
    ``bc`` (B, T, 2N) and ``dt = softplus(x·w_dt + dt_bias)`` (B, T, H) in
    float32."""
    xz = x @ p["w_xz"].to(x.dtype)
    xin, z = torch.chunk(xz, 2, dim=-1)
    bc = (x @ p["w_bc"].to(x.dtype)).to(torch.float32)
    dt = _softplus((x @ p["w_dt"].to(x.dtype)).to(torch.float32)
                   + p["dt_bias"].to(torch.float32))
    return xin, z, bc, dt


# The SSD on chunk-major float32 tensors: x (B, C, Q, H, P), dt (B, C, Q, H),
# bc (B, C, Q, 2N), a (H,), for C chunks of Q steps.
def ssd_intra(x, dt, bc, a):
    """Each chunk's cumulative log decay s (B, C, Q, H) and its output from
    its own steps: y[t] = Σ_{τ<=t} (C_t·B_τ) exp(s_t - s_τ) dt_τ x_τ."""
    n = bc.shape[-1] // 2
    bmat, cmat = bc[..., :n], bc[..., n:]
    s = torch.cumsum(a * dt, dim=2)
    cb = torch.einsum("bctn,bcsn->bcts", cmat, bmat)
    decay = torch.exp(torch.clamp(s[:, :, :, None, :] - s[:, :, None, :, :], -60.0, 0.0))
    q = x.shape[2]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    m = cb[..., None] * decay * dt[:, :, None, :, :]
    m = torch.where(causal[:, :, None], m, 0.0)
    return s, torch.einsum("bctsh,bcshp->bcthp", m, x)


def ssd_states(x, dt, bc, s, h0):
    """The state entering each chunk (B, C, H, N, P) and the one leaving
    the last, from ``h0`` (B, H, N, P): each chunk's own contribution
    dh = Σ_τ exp(s_Q - s_τ) dt_τ B_τ ⊗ x_τ for all chunks at once, then
    h_out = exp(s_Q) h_in + dh chunk by chunk."""
    n = bc.shape[-1] // 2
    w_last = torch.exp(torch.clamp(s[:, :, -1:, :] - s, -60.0, 0.0)) * dt
    dh = torch.einsum("bcqn,bcqhp->bchnp", bc[..., :n], w_last[..., None] * x)
    decay = torch.exp(s[:, :, -1, :])[..., None, None]
    h, h_in = h0, []
    for c in range(x.shape[1]):
        h_in.append(h)
        h = decay[:, c] * h + dh[:, c]
    return torch.stack(h_in, dim=1), h


def ssd_inter(bc, s, h_in):
    """Each chunk's output from the state entering it: exp(s_t) C_t h_in."""
    n = bc.shape[-1] // 2
    return torch.exp(s)[..., None] * torch.einsum("bctn,bchnp->bcthp", bc[..., n:], h_in)


def _ssd(x, dt, bc, a):
    s, y = ssd_intra(x, dt, bc, a)
    b, _, _, h, p = x.shape
    h0 = torch.zeros(b, h, bc.shape[-1] // 2, p, dtype=torch.float32, device=x.device)
    h_in, _ = ssd_states(x, dt, bc, s, h0)
    return y + ssd_inter(bc, s, h_in)


def _ssd_chunk(h_in, xs):
    """One chunk. h_in: (B,H,N,P). xs: x (B,Q,H,P), dt (B,Q,H), bc (B,Q,2N),
    a (H,). Returns (h_out, y (B,Q,H,P))."""
    x, dt, bc, a = xs
    x, dt, bc = (v.unsqueeze(1) for v in (x, dt, bc))
    s, y = ssd_intra(x, dt, bc, a)
    _, h_out = ssd_states(x, dt, bc, s, h_in)
    return h_out, (y + ssd_inter(bc, s, h_in.unsqueeze(1)))[:, 0]


def gate_norm(p, y, xh, z):
    """y (B, T, H, P) float32 gains d_skip·xh, is cast to z's type, gated by
    silu(z) (float32, cast back) and RMS-normed over its H·P (the rank's
    local heads): (B, T, H·P)."""
    b, t, h, pd = y.shape
    y = y + p["d_skip"].to(torch.float32)[None, None, :, None] * xh
    y = y.reshape(b, t, h * pd).to(z.dtype)
    y = y * F.silu(z.to(torch.float32)).to(z.dtype)
    return rmsnorm(y, p["norm_w"])


def mamba2_train(p, x: torch.Tensor, *, n_heads: int, head_dim: int, d_state: int,
                 chunk: int = 256, axes: Axes = SINGLE) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). T must be a multiple of min(chunk, T).
    ``n_heads`` are the rank's local heads; the out projection's partial
    sums are summed over ``axes``' model group."""
    b, t, _ = x.shape
    xin, z, bc, dt = in_proj(p, x)
    xin = _causal_conv(xin, p["conv_w"].to(x.dtype))
    a = -torch.exp(p["a_log"].to(torch.float32))
    xh = xin.reshape(b, t, n_heads, head_dim).to(torch.float32)
    q = min(chunk, t)
    assert t % q == 0, (t, q)
    nch = t // q
    y = checkpoint(
        _ssd, xh.reshape(b, nch, q, n_heads, head_dim), dt.reshape(b, nch, q, n_heads),
        bc.reshape(b, nch, q, 2 * d_state), a, use_reentrant=False,
    )
    y = gate_norm(p, y.reshape(b, t, n_heads, head_dim), xh, z)
    return axes.psum_tp(y @ p["w_out"].to(x.dtype))


def init_mamba2_cache(batch: int, *, n_heads: int, head_dim: int, d_state: int, device,
                      dtype=torch.float32):
    """One layer's decode state: {"conv": (B, K - 1, H·P) in ``dtype`` (the
    last K - 1 conv inputs), "h": (B, H, N, P) float32}, all zeros."""
    return {"conv": torch.zeros(batch, CONV_K - 1, n_heads * head_dim, dtype=dtype,
                                device=device),
            "h": torch.zeros(batch, n_heads, d_state, head_dim, dtype=torch.float32,
                             device=device)}


def mamba2_decode(p, x: torch.Tensor, cache, *, n_heads: int, head_dim: int, d_state: int,
                  axes: Axes = SINGLE):
    """One token per sequence. x: (B, 1, d); cache: :func:`init_mamba2_cache`'s,
    written in place. Returns ``(out (B, 1, d), cache)``. As in
    :func:`mamba2_train`, ``n_heads`` are the rank's local heads (its
    ``w_xz`` slice split in half locally, the gate's norm over its own
    heads) and the out projection's partial sums are summed over ``axes``'
    model group."""
    b, n = x.shape[0], d_state
    xz = (x @ p["w_xz"].to(x.dtype))[:, 0]
    xin, z = torch.chunk(xz, 2, dim=-1)
    ct = torch.promote_types(cache["conv"].dtype, xin.dtype)
    hist = torch.cat([cache["conv"].to(ct), xin[:, None, :].to(ct)], dim=1)  # (B, K, C)
    prod = hist * p["conv_w"].to(x.dtype)[None]
    conv = torch.sum(prod, dim=1, dtype=torch.float32).to(prod.dtype)
    xh = F.silu(conv.to(torch.float32)).reshape(b, n_heads, head_dim)
    cache["conv"].copy_(hist[:, 1:])
    x0 = x[:, 0]
    bc = (x0 @ p["w_bc"].to(x.dtype)).to(torch.float32)
    dt = _softplus((x0 @ p["w_dt"].to(x.dtype)).to(torch.float32)
                   + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))
    decay = torch.exp(a[None, :] * dt)  # (B, H)
    h = decay[:, :, None, None] * cache["h"] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bc[:, :n], xh)
    cache["h"].copy_(h)
    y = torch.einsum("bn,bhnp->bhp", bc[:, n:], h)
    y = y + p["d_skip"].to(torch.float32)[None, :, None] * xh
    y = y.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)[:, None, :]
    y = rmsnorm(y, p["norm_w"])
    return axes.psum_tp(y @ p["w_out"].to(x.dtype)), cache
