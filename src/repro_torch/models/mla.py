"""Multi-head Latent Attention, train path (port of
``repro/models/mla.py::mla_train`` at tp = 1; DeepSeek-V2).

  c_kv = x @ w_dkv                      (T, kv_lora)   the shared latent
  k_c, v = c_kv @ w_uk, c_kv @ w_uv     per-head decompression
  k_r  = RoPE(x @ w_kr)                 (T, 64)        one rotary key for all heads
  q    = x @ w_q, split per head into [head_dim content | 64 rotary]

Each head attends with [q_c | RoPE(q_r)] against [k_c | k_r], causal, in
float32 at scale 1/√(head_dim + 64), through the same pinned
memory-efficient SDPA as ``models/attention.py``. The JAX package pads V
with zeros to head_dim + 64 for its shared chunked kernel and slices the
output; here V keeps its head_dim (the backend takes Ev ≠ E), which gives
the same values. ``mla_decode`` and the latent cache wait for the serving
slice.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import sdpa_f32
from repro_torch.models.common import rope

DH_ROPE = 64


def mla_train(p, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
              head_dim: int) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). p: {"w_dkv", "w_kr", "w_q", "w_uk",
    "w_uv", "wo"}."""
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
    return out @ p["wo"].to(x.dtype)
