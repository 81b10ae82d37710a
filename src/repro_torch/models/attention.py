"""Causal GQA self-attention, train path (port of
``repro/models/attention.py::attention_train`` at tp = 1).

The JAX package computes attention with a chunked online softmax in plain
XLA code (``_chunked_attn``), not a Pallas kernel, in float32 whatever the
activation type. The port keeps that precision and calls PyTorch's
``scaled_dot_product_attention`` on float32 q, k, v; no TPU kernel stands
behind it. Sliding windows and QKV biases are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import rope


def attention_train(p, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    rope_theta: float = 10000.0) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). p: {"wq", "wk", "wv", "wo"}."""
    b, t, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    q = rope(q.reshape(b, t, n_heads, head_dim), positions, rope_theta)
    k = rope(k.reshape(b, t, n_kv_heads, head_dim), positions, rope_theta)
    v = v.reshape(b, t, n_kv_heads, head_dim)
    group = n_heads // n_kv_heads
    # (B, H, T, dh) in float32; query head h reads KV head h // group, the
    # JAX package's (Hkv, group) split of the query heads
    qf = q.to(torch.float32).transpose(1, 2)
    kf = k.to(torch.float32).transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).transpose(1, 2).repeat_interleave(group, dim=1)
    out = F.scaled_dot_product_attention(qf, kf, vf, is_causal=True)
    out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim).to(x.dtype)
    return out @ p["wo"].to(x.dtype)
