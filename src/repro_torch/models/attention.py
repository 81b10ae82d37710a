"""Causal GQA self-attention, train path (port of
``repro/models/attention.py::attention_train`` at tp = 1), with the optional
QKV bias and sliding window of the JAX package, and the unmasked,
non-causal case of its ``_chunked_attn`` (``causal=False`` masks only
padding) that the encoder-decoder's bidirectional encoder and its cross
attention take, the latter with Tq != Tk (:func:`gqa_attend`).

The JAX package computes attention with a chunked online softmax in plain
XLA code (``_chunked_attn``), not a Pallas kernel, in float32 whatever the
activation type. The port keeps that precision and calls PyTorch's
``scaled_dot_product_attention`` on float32 q, k, v; no TPU kernel stands
behind it. With a window the mask is explicit: query p sees keys
p - window + 1 ... p (``_chunked_attn``'s ``kv_pos <= q_pos`` and
``kv_pos > q_pos - window``).

On the card the call is pinned to PyTorch's memory-efficient backend, the
only one that takes float32 (with or without a mask) without materialising
the (B, H, T, T) scores: a fallback to the math backend would raise rather
than run slowly (8.6 GB a layer of scores for h2o-danube at T = 8192).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from repro_torch.models.common import rope


def window_mask(t: int, window: int, device) -> torch.Tensor:
    """(T, T) bool, True where query row q may attend key column k:
    q - window < k <= q."""
    pos = torch.arange(t, device=device)
    rel = pos[:, None] - pos[None, :]
    return (rel >= 0) & (rel < window)


def sdpa_f32(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
             attn_mask: torch.Tensor | None = None, *, causal: bool = True) -> torch.Tensor:
    """Attention of float32 (B, H, Tq, E) q, (B, H, Tk, E) k and (B, H, Tk,
    Ev) v at scale 1/√E: causal, under ``attn_mask``, or with ``causal``
    false and no mask every query over every key (Tq may differ from Tk);
    on the card pinned to the memory-efficient backend, which raises rather
    than fall back."""
    pin = (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if qf.device.type == "cuda"
           else contextlib.nullcontext())
    with pin:
        if attn_mask is None:
            return F.scaled_dot_product_attention(qf, kf, vf, is_causal=causal)
        return F.scaled_dot_product_attention(qf, kf, vf, attn_mask=attn_mask)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
               window: int | None = None) -> torch.Tensor:
    """q: (B, Tq, Hq, dh); k, v: (B, Tk, Hkv, dh) -> (B, Tq, Hq·dh) in q's
    type, computed in float32. Query head h reads KV head h // group, the
    JAX package's (Hkv, group) split of the query heads. Causal (with an
    optional window) or, with ``causal`` false, unmasked."""
    b, tq, hq, dh = q.shape
    group = hq // k.shape[2]
    qf = q.to(torch.float32).transpose(1, 2)
    kf = k.to(torch.float32).transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).transpose(1, 2).repeat_interleave(group, dim=1)
    mask = None if window is None else window_mask(tq, window, q.device)
    out = sdpa_f32(qf, kf, vf, mask, causal=causal)
    return out.transpose(1, 2).reshape(b, tq, hq * dh).to(q.dtype)


def attention_train(p, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    rope_theta: float = 10000.0, window: int | None = None) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). p: {"wq", "wk", "wv", "wo"} and, with QKV
    bias, {"bq", "bk", "bv"}, added before RoPE in the activation type."""
    b, t, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = rope(q.reshape(b, t, n_heads, head_dim), positions, rope_theta)
    k = rope(k.reshape(b, t, n_kv_heads, head_dim), positions, rope_theta)
    v = v.reshape(b, t, n_kv_heads, head_dim)
    return gqa_attend(q, k, v, window=window) @ p["wo"].to(x.dtype)
