"""xLSTM blocks (port of ``repro/models/xlstm.py``): the train path
(``_mlstm_chunk``, ``mlstm_train``, ``_slstm_cell``, ``slstm_train``), at
tp > 1 on the rank's heads of a model axis, and the one-token decode with
its O(1) state (``init_mlstm_cache``, ``mlstm_decode``,
``init_slstm_cache``, ``slstm_decode``), at tp > 1 the same way.

Tensor parallelism, as in the JAX package: the heads are sharded over the
model axis and each cell's out projection is row-parallel
(``axes.psum_tp``); every cell's recurrence is head-local, so the sLSTM's
hand-written backward needs no collective. The mLSTM's ``w_if`` and
``if_bias`` are laid out ``[i | f]`` globally, and each rank's slice is
split at its own head count: at tp = 2 rank 0's local gates are all
global input gates (bias -2) and rank 1's all forget gates (bias 3). The
``norm_w`` RMSNorm takes the mean over the rank's own H_loc·dh. Both are
the reference's behaviour, which the port keeps.

mLSTM (matrix memory, per head; f = sigmoid(f̃), i = exp(min(ĩ, 0))):
    C_t = f_t C_{t-1} + i_t (k_t ⊗ v_t),   n_t = f_t n_{t-1} + i_t k_t,
    y_t = (q_t C_t) / max(|q_t·n_t|, 1).
The JAX package trains it in chunks of 256 (a masked quadratic form inside
a chunk, the state carried by ``lax.scan``), in plain XLA code, not a
Pallas kernel. The port keeps every element's arithmetic (the clips of the
log decays to [-60, 30] and [-60, 0], the causal mask, float32) but, as
``models/ssm.py`` does for the SSD, computes the terms that do not read the
carried state — the intra-chunk output and normaliser, and each chunk's own
contribution to C and n — for all chunks at once; only the carry
``C = f_all·C + dC`` (and n) runs chunk by chunk (:func:`mlstm_states`).

sLSTM (scalar memory, per head, a recurrent block-diagonal projection
``r_h``): a loop over every time step, as the JAX package's ``lax.scan``,
in float32 (:func:`slstm_scan`), its backward written out by hand
(:class:`_SlstmScan`). ``r_h`` is cast to float32 once, so with bf16
params its gradient sums over the time steps in float32; the JAX package
casts it inside each step, and its scan sums the steps' bf16 gradients in
bf16.

The stages (:func:`mlstm_proj`, :func:`mlstm_intra`, :func:`mlstm_states`,
:func:`mlstm_inter`, :func:`slstm_proj`, :func:`slstm_scan`,
:func:`out_proj`) are separate functions so that each can be timed alone.

The decode steps (:func:`mlstm_decode`, :func:`slstm_decode`) carry each
head's state in float32 (mLSTM: C (dh, dh) and n (dh,); sLSTM: h and c)
and write it in place. The mLSTM step divides q and k by √dh as the JAX
package does, by a float32 tensor: a division by a Python scalar becomes a
product with its reciprocal on the card, which rounds differently. The
sLSTM step is one step of :func:`slstm_scan_reference` (:func:`slstm_cell`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.common import SINGLE, Axes, rmsnorm


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x)) as ``jax.nn.log_sigmoid`` defines it:
    -softplus(-x) = -logaddexp(-x, 0)."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype, device=x.device))


def out_proj(p, y: torch.Tensor, dtype, axes: Axes = SINGLE) -> torch.Tensor:
    """y (B, T, H·dh) float32 cast to ``dtype``, RMS-normed by ``norm_w``
    over its H·dh (the rank's local heads), then ``w_out``, the partial
    sums summed over ``axes``' model group."""
    y = rmsnorm(y.to(dtype), p["norm_w"])
    return axes.psum_tp(y @ p["w_out"].to(dtype))


# ---------------------------------------------------------------------------
# mLSTM, on chunk-major float32 tensors: q, k, v (B, C, Q, H, dh), logf and
# logi (B, C, Q, H), for C chunks of Q steps
# ---------------------------------------------------------------------------
def mlstm_proj(p, x: torch.Tensor, n_heads: int, head_dim: int):
    """The projections in x's type, then float32: q and k divided by √dh,
    v, and the gates' logs ``logi = min(ĩ, 0)``, ``logf = log_sigmoid(f̃)``
    (B, T, H) from ``w_if`` and ``if_bias``."""
    b, t, _ = x.shape
    to = lambda w: (x @ w.to(x.dtype)).to(torch.float32)
    scale = math.sqrt(float(head_dim))
    q = to(p["w_q"]).reshape(b, t, n_heads, head_dim) / scale
    k = to(p["w_k"]).reshape(b, t, n_heads, head_dim) / scale
    v = to(p["w_v"]).reshape(b, t, n_heads, head_dim)
    gi = to(p["w_if"]) + p["if_bias"].to(torch.float32)
    return q, k, v, torch.clamp(gi[..., :n_heads], max=0.0), _log_sigmoid(gi[..., n_heads:])


def mlstm_intra(q, k, v, logf, logi):
    """Each chunk's cumulative log forget s (B, C, Q, H) and its output and
    normaliser from its own steps: with A[t, τ] = exp(s_t - s_τ + logi_τ)
    (q_t·k_τ) for τ <= t, y = A v and n = A k (B, C, Q, H, dh)."""
    s = torch.cumsum(logf, dim=2)
    qk = torch.einsum("bcthd,bcshd->bctsh", q, k)
    decay = torch.exp(torch.clamp(
        s[:, :, :, None, :] - s[:, :, None, :, :] + logi[:, :, None, :, :], -60.0, 30.0))
    qlen = q.shape[2]
    causal = torch.tril(torch.ones(qlen, qlen, dtype=torch.bool, device=q.device))
    # the masked entries may reach e^30 before the where; their gradient is 0
    att = torch.where(causal[:, :, None], qk * decay, 0.0)
    y = torch.einsum("bctsh,bcshd->bcthd", att, v)
    n = torch.einsum("bctsh,bcshd->bcthd", att, k)
    return s, y, n


def mlstm_states(k, v, logi, s, c0, n0):
    """The state entering each chunk, C (B, C, H, dh, dh) and n (B, C, H,
    dh), from ``c0`` and ``n0``: each chunk's own contribution dC = Σ_τ
    w_τ k_τ ⊗ v_τ and dn = Σ_τ w_τ k_τ, w_τ = exp(s_Q - s_τ + logi_τ), for
    all chunks at once, then C = exp(s_Q)·C + dC (and n) chunk by chunk."""
    w_last = torch.exp(torch.clamp(s[:, :, -1:, :] - s + logi, -60.0, 30.0))
    dc = torch.einsum("bcqh,bcqhd,bcqhe->bchde", w_last, k, v)
    dn = torch.einsum("bcqh,bcqhd->bchd", w_last, k)
    f_all = torch.exp(torch.clamp(s[:, :, -1, :], -60.0, 0.0))
    c, n, c_in, n_in = c0, n0, [], []
    for i in range(k.shape[1]):
        c_in.append(c)
        n_in.append(n)
        c = f_all[:, i, :, None, None] * c + dc[:, i]
        n = f_all[:, i, :, None] * n + dn[:, i]
    return torch.stack(c_in, dim=1), torch.stack(n_in, dim=1)


def mlstm_inter(q, s, y_intra, n_intra, c_in, n_in):
    """Each chunk's output from the state entering it, added to its own,
    over the normaliser max(|q·n|, 1): (B, C, Q, H, dh)."""
    w_t = torch.exp(torch.clamp(s, -60.0, 0.0))[..., None]
    y_inter = w_t * torch.einsum("bcthd,bchde->bcthe", q, c_in)
    n_inter = w_t * n_in[:, :, None]
    denom = torch.clamp(torch.abs(torch.sum(q * (n_intra + n_inter), dim=-1)), min=1.0)
    return (y_intra + y_inter) / denom[..., None]


def mlstm_train(p, x: torch.Tensor, *, n_heads: int, head_dim: int,
                chunk: int = 256, axes: Axes = SINGLE) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). T must be a multiple of min(chunk, T).
    ``n_heads`` are the rank's local heads."""
    b, t, _ = x.shape
    q, k, v, logi, logf = mlstm_proj(p, x, n_heads, head_dim)
    qc = min(chunk, t)
    assert t % qc == 0, (t, qc)
    chunks = lambda a: a.reshape(b, t // qc, qc, *a.shape[2:])
    q, k, v, logi, logf = (chunks(a) for a in (q, k, v, logi, logf))
    s, y_intra, n_intra = mlstm_intra(q, k, v, logf, logi)
    c0 = torch.zeros(b, n_heads, head_dim, head_dim, dtype=torch.float32, device=x.device)
    n0 = torch.zeros(b, n_heads, head_dim, dtype=torch.float32, device=x.device)
    c_in, n_in = mlstm_states(k, v, logi, s, c0, n0)
    y = mlstm_inter(q, s, y_intra, n_intra, c_in, n_in)
    return out_proj(p, y.reshape(b, t, n_heads * head_dim), x.dtype, axes)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_proj(p, x: torch.Tensor) -> torch.Tensor:
    """The input's gate pre-activations ``x·w_in + b``, added in x's type,
    then float32: (B, T, 4·H·dh), head-major (each head's i, f, g, o)."""
    return (x @ p["w_in"].to(x.dtype) + p["b"].to(x.dtype)).to(torch.float32)


def _gate_steps(x: torch.Tensor, dh: int):
    """A (T, ..., 4·dh) buffer's per-step views of its i, f, g and o
    columns: four tuples of T views, made in four calls rather than in the
    time loop (a view made per step costs the host about as much as a
    kernel launch)."""
    return [x[..., k * dh:(k + 1) * dh].unbind(0) for k in range(4)]


class _SlstmScan(torch.autograd.Function):
    """The sLSTM cell over every time step, float32, its backward written
    out by hand in plain PyTorch: the forward records no autograd graph
    (each step's pre-activations, gates, cell state and tanh(c) go into
    buffers that hold the whole sequence; 10 ops a step), and the backward
    computes the factors that do not depend on the recurrence for all steps
    at once, leaving 5 ops a step in its reverse loop. The derivatives are
    the JAX package's autodiff rules: sigmoid' = s(1 - s), tanh' = 1 - t²,
    and exp(min(z, 0))' = exp(z) where z < 0, else 0.

    z_all: (T, H, B, 4·dh), heads leading; r: (H, dh, 4·dh). Returns the
    hidden states (T, H, B, dh)."""

    @staticmethod
    def forward(ctx, z_all, r):
        t_len, n_heads, b, four_dh = z_all.shape
        dh = four_dh // 4
        z = torch.empty_like(z_all)  # pre-activations, h_{t-1} @ r added
        gates = torch.empty_like(z_all)  # i, f, g, o
        cs = z_all.new_zeros(t_len + 1, n_heads, b, dh)  # c_0 = 0, ..., c_T
        hs = z_all.new_zeros(t_len + 1, n_heads, b, dh)  # h_0 = 0, ..., h_T
        tc = z_all.new_empty(t_len, n_heads, b, dh)  # tanh(c_t)
        z_in, z_t, c_t, h_t, tc_t = (v.unbind(0) for v in (z_all, z, cs, hs, tc))
        (zi, zf, zg, zo), (gi, gf, gg, go) = _gate_steps(z, dh), _gate_steps(gates, dh)
        for t in range(t_len):
            torch.baddbmm(z_in[t], h_t[t], r, out=z_t[t])
            torch.clamp(zi[t], max=0.0, out=gi[t]).exp_()
            torch.sigmoid(zf[t], out=gf[t])
            torch.tanh(zg[t], out=gg[t])
            torch.sigmoid(zo[t], out=go[t])
            torch.mul(gf[t], c_t[t], out=c_t[t + 1]).addcmul_(gi[t], gg[t])
            torch.mul(go[t], torch.tanh(c_t[t + 1], out=tc_t[t]), out=h_t[t + 1])
        ctx.save_for_backward(z, gates, cs, tc, hs, r)
        return hs[1:]

    @staticmethod
    def backward(ctx, grad_hs):
        z, gates, cs, tc, hs, r = ctx.saved_tensors
        t_len, n_heads, b, four_dh = z.shape
        dh = four_dh // 4
        gi, gf, gg, go = gates.split(dh, dim=-1)
        # dc_t = dc_{t+1}·f_{t+1} + dh_t·a_t, dz_t = [dc_t, dc_t, dc_t, dh_t]·m_t
        a = go * (1.0 - tc * tc)
        m = torch.cat([
            torch.where(z[..., :dh] < 0.0, gi, 0.0) * gg,  # i
            cs[:-1] * (gf * (1.0 - gf)),  # f
            gi * (1.0 - gg * gg),  # g
            tc * (go * (1.0 - go)),  # o
        ], dim=-1)
        dz = torch.empty_like(z)
        steps = lambda v: v.unbind(0)
        g_t, a_t, f_t, dz_t = steps(grad_hs.contiguous()), steps(a), steps(gf), steps(dz)
        dz3, m3 = (steps(v[..., :3 * dh].unflatten(-1, (3, dh))) for v in (dz, m))
        dzo, mo = (steps(v[..., 3 * dh:]) for v in (dz, m))
        r_t = r.transpose(1, 2)
        dc = torch.zeros_like(cs[0])
        for t in reversed(range(t_len)):
            d_h = g_t[t] if t == t_len - 1 else torch.baddbmm(g_t[t], dz_t[t + 1], r_t)
            dc = torch.addcmul(dc, d_h, a_t[t])
            torch.mul(m3[t], dc.unsqueeze(2), out=dz3[t])
            torch.mul(mo[t], d_h, out=dzo[t])
            dc = dc * f_t[t]
        # dr = Σ_t h_{t-1}ᵀ dz_t per head
        h_prev = hs[:-1].permute(1, 3, 0, 2).reshape(n_heads, dh, t_len * b)
        dr = torch.bmm(h_prev, dz.permute(1, 0, 2, 3).reshape(n_heads, t_len * b, four_dh))
        return dz, dr


def slstm_scan(zx: torch.Tensor, r_h: torch.Tensor, n_heads: int,
               head_dim: int) -> torch.Tensor:
    """The cell over every time step from h = c = 0, float32: each step's
    zx_t (B, 4·H·dh) is read as (B, H, 4·dh) and gains h_{t-1} @ r_h per
    head; its last axis splits into i, f, g, o, and

        c = sigmoid(f)·c + exp(min(i, 0))·tanh(g),  h = sigmoid(o)·tanh(c).

    Returns the hidden states (B, T, H·dh). Heads lead each step's tensors
    (H, B, ·), so that one ``baddbmm`` adds the recurrent product
    (:class:`_SlstmScan`)."""
    b, t, _ = zx.shape
    z_all = zx.reshape(b, t, n_heads, 4 * head_dim).permute(1, 2, 0, 3).contiguous()
    hs = _SlstmScan.apply(z_all, r_h.to(torch.float32))
    return hs.permute(2, 0, 1, 3).reshape(b, t, n_heads * head_dim)


def slstm_cell(zx_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor, r: torch.Tensor,
               n_heads: int, head_dim: int):
    """One step of the cell as the JAX package's ``_slstm_cell`` writes it,
    float32: zx_t (B, 4·H·dh) read as (B, H, 4·dh) gains h @ r per head
    (h, c: (B, H, dh); r: (H, dh, 4·dh) float32), splits into i, f, g, o,
    and ``c = sigmoid(f)·c + exp(min(i, 0))·tanh(g)``,
    ``h = sigmoid(o)·tanh(c)``. Returns the new (h, c)."""
    z = zx_t.reshape(zx_t.shape[0], n_heads, 4 * head_dim) + torch.einsum("bhd,hde->bhe", h, r)
    zi, zf, zg, zo = torch.split(z, head_dim, dim=-1)
    c = torch.sigmoid(zf) * c + torch.exp(torch.clamp(zi, max=0.0)) * torch.tanh(zg)
    return torch.sigmoid(zo) * torch.tanh(c), c


def slstm_scan_reference(zx: torch.Tensor, r_h: torch.Tensor, n_heads: int,
                         head_dim: int) -> torch.Tensor:
    """:func:`slstm_scan` as the JAX package writes its step, each step
    (:func:`slstm_cell`) through autograd: the reference that the
    hand-written backward is held to (on the CPU by the tests, on the card
    by ``chip_smoke.py``)."""
    b, t, _ = zx.shape
    r = r_h.to(torch.float32)
    h = torch.zeros(b, n_heads, head_dim, dtype=torch.float32, device=zx.device)
    c = torch.zeros_like(h)
    hs = []
    for i in range(t):
        h, c = slstm_cell(zx[:, i], h, c, r, n_heads, head_dim)
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(b, t, n_heads * head_dim)


def slstm_train(p, x: torch.Tensor, *, n_heads: int, head_dim: int,
                axes: Axes = SINGLE) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d); ``n_heads`` are the rank's local heads."""
    hs = slstm_scan(slstm_proj(p, x), p["r_h"], n_heads, head_dim)
    return out_proj(p, hs, x.dtype, axes)


# ---------------------------------------------------------------------------
# decode: one token per sequence, the state written in place
# ---------------------------------------------------------------------------
def init_mlstm_cache(batch: int, *, n_heads: int, head_dim: int, device):
    """One mLSTM layer's state: {"C": (B, H, dh, dh), "n": (B, H, dh)},
    float32 zeros."""
    return {"C": torch.zeros(batch, n_heads, head_dim, head_dim, dtype=torch.float32,
                             device=device),
            "n": torch.zeros(batch, n_heads, head_dim, dtype=torch.float32, device=device)}


def mlstm_decode(p, x: torch.Tensor, cache, *, n_heads: int, head_dim: int,
                 axes: Axes = SINGLE):
    """x: (B, 1, d); cache: :func:`init_mlstm_cache`'s, written in place.
    Returns ``(out (B, 1, d), cache)``; ``n_heads`` are the rank's local
    heads (its ``[i | f]`` slice split at them) and the out projection is
    row-parallel over ``axes``."""
    b, h, dh = x.shape[0], n_heads, head_dim
    to = lambda w: (x[:, 0] @ w.to(x.dtype)).to(torch.float32)
    # √dh in float32 as a one-element tensor: a true division on the card too
    root = torch.full((1,), float(np.sqrt(np.float32(dh))), dtype=torch.float32,
                      device=x.device)
    q = to(p["w_q"]).reshape(b, h, dh) / root
    k = to(p["w_k"]).reshape(b, h, dh) / root
    v = to(p["w_v"]).reshape(b, h, dh)
    gi = to(p["w_if"]) + p["if_bias"].to(torch.float32)
    i_g = torch.exp(torch.clamp(gi[..., :h], max=0.0))
    f_g = torch.sigmoid(gi[..., h:])
    c = f_g[:, :, None, None] * cache["C"] + i_g[:, :, None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = f_g[:, :, None] * cache["n"] + i_g[:, :, None] * k
    cache["C"].copy_(c)
    cache["n"].copy_(n)
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), min=1.0)
    y = torch.einsum("bhd,bhde->bhe", q, c) / denom[..., None]
    return out_proj(p, y.reshape(b, 1, h * dh), x.dtype, axes), cache


def init_slstm_cache(batch: int, *, n_heads: int, head_dim: int, device):
    """One sLSTM layer's state: {"h", "c": (B, H, dh)}, float32 zeros."""
    return {k: torch.zeros(batch, n_heads, head_dim, dtype=torch.float32, device=device)
            for k in ("h", "c")}


def slstm_decode(p, x: torch.Tensor, cache, *, n_heads: int, head_dim: int,
                 axes: Axes = SINGLE):
    """x: (B, 1, d); cache: :func:`init_slstm_cache`'s, written in place.
    Returns ``(out (B, 1, d), cache)``; ``n_heads`` are the rank's local
    heads and the out projection is row-parallel over ``axes``."""
    b = x.shape[0]
    zx = slstm_proj(p, x)[:, 0]
    h, c = slstm_cell(zx, cache["h"], cache["c"], p["r_h"].to(torch.float32), n_heads,
                      head_dim)
    cache["h"].copy_(h)
    cache["c"].copy_(c)
    return out_proj(p, h.reshape(b, 1, n_heads * head_dim), x.dtype, axes), cache
