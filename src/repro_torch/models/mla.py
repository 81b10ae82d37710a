"""Multi-head Latent Attention, train path (port of
``repro/models/mla.py::mla_train``; DeepSeek-V2). At tp > 1 each rank
decompresses and attends its local heads (``w_q``, ``w_uk``, ``w_uv``
column-parallel, ``wo`` row-parallel with a psum over the model group);
the latent projections ``w_dkv`` and ``w_kr`` are replicated.

  c_kv = x @ w_dkv                      (T, kv_lora)   the shared latent
  k_c, v = c_kv @ w_uk, c_kv @ w_uv     per-head decompression
  k_r  = RoPE(x @ w_kr)                 (T, 64)        one rotary key for all heads
  q    = x @ w_q, split per head into [head_dim content | 64 rotary]

Each head attends with [q_c | RoPE(q_r)] against [k_c | k_r], causal, in
float32 at scale 1/√(head_dim + 64), through the same pinned
memory-efficient SDPA as ``models/attention.py``. The JAX package pads V
with zeros to head_dim + 64 for its shared chunked kernel and slices the
output; here V keeps its head_dim (the backend takes Ev ≠ E), which gives
the same values.

Decode (:func:`mla_decode`, the JAX package's; at tp > 1 on the rank's
local heads, the latent cache replicated over the model axis) keeps the
latent cache (:func:`init_mla_cache`): ``c_kv`` (kv_lora) and the rotary key
``k_r`` (64) per token in place of 2·H·head_dim, the paper's KV-cache
compression, and decompresses the whole cache through ``w_uk`` and
``w_uv`` at every step. As in the JAX package its RoPE takes the default
theta (10,000, not the config's ``rope_theta``) and its softmax is the
library's (``torch.softmax`` for ``jax.nn.softmax``), not attention's
explicit form. A sequence-sharded latent cache is refused
(:func:`refuse_sequence_shards`).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import EMPTY_POS, NEG_INF, f32_scale, sdpa_f32, write_slots
from repro_torch.models.common import SINGLE, Axes, rope

DH_ROPE = 64


def mla_train(p, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
              head_dim: int, axes: Axes = SINGLE) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). p: {"w_dkv", "w_kr", "w_q", "w_uk",
    "w_uv", "wo"}; ``n_heads`` the rank's local heads."""
    b, t, _ = x.shape
    c_kv = x @ p["w_dkv"].to(x.dtype)
    k_r = rope((x @ p["w_kr"].to(x.dtype)).reshape(b, t, 1, DH_ROPE), positions)
    k_c = (c_kv @ p["w_uk"].to(x.dtype)).reshape(b, t, n_heads, head_dim)
    v = (c_kv @ p["w_uv"].to(x.dtype)).reshape(b, t, n_heads, head_dim)
    q = (x @ p["w_q"].to(x.dtype)).reshape(b, t, n_heads, head_dim + DH_ROPE)
    q_full = torch.cat([q[..., :head_dim], rope(q[..., head_dim:], positions)], dim=-1)
    k_full = torch.cat([k_c, k_r.expand(b, t, n_heads, DH_ROPE)], dim=-1)
    qf, kf, vf = (a.to(torch.float32).transpose(1, 2) for a in (q_full, k_full, v))
    out = sdpa_f32(qf, kf, vf)
    out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim).to(x.dtype)
    return axes.psum_tp(out @ p["wo"].to(x.dtype))


def init_mla_cache(batch: int, seq: int, *, kv_lora: int, device, dtype=torch.bfloat16):
    """One layer's latent cache: {"c_kv": (B, S, kv_lora), "k_r": (B, S,
    64) in ``dtype``, "kv_pos": (B, S) int32}, every slot empty."""
    return {"c_kv": torch.zeros((batch, seq, kv_lora), dtype=dtype, device=device),
            "k_r": torch.zeros((batch, seq, DH_ROPE), dtype=dtype, device=device),
            "kv_pos": torch.full((batch, seq), EMPTY_POS, dtype=torch.int32, device=device)}


def refuse_sequence_shards(axes: Axes) -> None:
    """Raise on a sequence-sharded latent cache: the JAX package's
    ``mla_decode`` has no ``axes.sp`` branch, so under its
    ``build_serve_step`` at a batch smaller than the data replicas every
    shard writes position p at local slot clip(p, 0, S_loc - 1) and attends
    its own slots alone. Past S_loc tokens each new token overwrites the
    last slot and the history there is lost, silently (ROADMAP's reference
    behaviours)."""
    if axes.sp is not None:
        raise NotImplementedError(
            "MLA decode on a sequence-sharded cache (a batch smaller than the data "
            "replicas): the reference's mla_decode has no sequence-parallel branch and "
            "overwrites its last local slot past S / n_dp tokens; serve MLA with a "
            "global batch of at least the data replicas")


def mla_decode(p, x: torch.Tensor, pos: torch.Tensor, cache, *, n_heads: int,
               head_dim: int, axes: Axes = SINGLE):
    """One token per sequence against the latent cache, written at ``pos``
    in place. x: (B, 1, d); pos: (B,). ``n_heads`` the rank's local heads
    (``w_q``, ``w_uk``, ``w_uv`` its columns, ``wo`` its rows, summed over
    ``axes``' model group); the latent cache is the same on every rank of
    the group. Returns ``(out (B, 1, d), cache)``."""
    refuse_sequence_shards(axes)
    b = x.shape[0]
    c_new = (x @ p["w_dkv"].to(x.dtype))[:, 0]
    k_r_new = rope((x @ p["w_kr"].to(x.dtype)).reshape(b, 1, 1, DH_ROPE), pos[:, None])
    write_slots(cache, pos, {"c_kv": c_new, "k_r": k_r_new[:, 0, 0]})
    s_len = cache["c_kv"].shape[1]
    c_kv = cache["c_kv"].to(x.dtype)
    k_c = (c_kv @ p["w_uk"].to(x.dtype)).reshape(b, s_len, n_heads, head_dim)
    v = (c_kv @ p["w_uv"].to(x.dtype)).reshape(b, s_len, n_heads, head_dim)
    q = (x @ p["w_q"].to(x.dtype)).reshape(b, 1, n_heads, head_dim + DH_ROPE)
    q_c, q_r = q[..., :head_dim], rope(q[..., head_dim:], pos[:, None])
    logits = torch.einsum("bhd,bshd->bhs", q_c[:, 0].to(torch.float32),
                          k_c.to(torch.float32))
    logits = logits + torch.einsum("bhr,bsr->bhs", q_r[:, 0].to(torch.float32),
                                   cache["k_r"].to(torch.float32))
    logits = logits * f32_scale(head_dim + DH_ROPE)
    mask = cache["kv_pos"][:, None, :] <= pos[:, None, None]
    w = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bhs,bshd->bhd", w, v.to(torch.float32))
    out = out.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    return axes.psum_tp(out @ p["wo"].to(x.dtype)), cache
