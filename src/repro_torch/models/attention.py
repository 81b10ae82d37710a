"""Causal GQA self-attention, train path (port of
``repro/models/attention.py::attention_train``; at tp > 1 on the rank's
local heads, the QKV projections column-parallel and the out projection
row-parallel, a psum over the model group), with the optional
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

The decode path (:func:`attention_decode`, port of the JAX package's
``attention_decode``) steps one token per sequence against a KV
cache (:func:`init_cache`): float32 logits over the whole cache under the
causal ``kv_pos <= pos`` mask (and the window), and the JAX package's
explicit softmax — max, ``exp``, sum, then a division by max(sum, 1e-30) —
in plain PyTorch, as the JAX package's is plain XLA. At tp > 1 it runs the
rank's local heads and sums the out projection over the model group; with
``axes.sp`` (a batch smaller than the data replicas) the cache's sequence
is sharded over the data group and the softmax is combined across the
shards (``pmax_sp``, ``psum_sp``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from repro_torch.models.common import SINGLE, Axes, rope

NEG_INF = -1e30
EMPTY_POS = 2**30  # kv_pos of a cache slot never written: masked for every query


def f32_scale(dim: int) -> float:
    """1/√dim as the JAX package computes it in float32 (a float32 sqrt,
    then a float32 division), as a Python float: a float32 tensor times it
    rounds as the product of two float32 values, and no device tensor (an
    upload that waits for the card) is made."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dim)))


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
                    rope_theta: float = 10000.0, window: int | None = None,
                    axes: Axes = SINGLE) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). p: {"wq", "wk", "wv", "wo"} and, with QKV
    bias, {"bq", "bk", "bv"}, added before RoPE in the activation type.
    ``n_heads`` and ``n_kv_heads`` are the rank's local heads; the out
    projection's partial sums are summed over ``axes``' model group."""
    b, t, _ = x.shape
    q, k, v = _qkv(p, x)
    q = rope(q.reshape(b, t, n_heads, head_dim), positions, rope_theta)
    k = rope(k.reshape(b, t, n_kv_heads, head_dim), positions, rope_theta)
    v = v.reshape(b, t, n_kv_heads, head_dim)
    return axes.psum_tp(gqa_attend(q, k, v, window=window) @ p["wo"].to(x.dtype))


def _qkv(p, x: torch.Tensor):
    """x @ wq, wk, wv in the activation type, with the QKV bias if any."""
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def init_cache(batch: int, seq: int, *, n_kv_heads: int, head_dim: int, device,
               dtype=torch.bfloat16):
    """One layer's KV cache: {"k", "v": (B, S, Hkv, dh) in ``dtype``,
    "kv_pos": (B, S) int32}, every slot empty (``EMPTY_POS``)."""
    kv = (batch, seq, n_kv_heads, head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "kv_pos": torch.full((batch, seq), EMPTY_POS, dtype=torch.int32, device=device)}


def write_slots(cache, pos: torch.Tensor, new, *, slot: torch.Tensor | None = None,
                ok: torch.Tensor | None = None) -> None:
    """Write ``new[name]`` (B, ...) into ``cache[name]`` at row b, slot
    clip(pos[b], 0, S - 1), and ``pos`` into ``kv_pos``; in place. A
    sequence-sharded cache passes its local ``slot`` (pos minus the
    shard's offset) and ``ok`` (B,) bool, True on the shard that owns the
    position: a row whose ``ok`` is False keeps its slot as it was."""
    s_len = cache["kv_pos"].shape[1]
    bidx = torch.arange(pos.shape[0], device=pos.device)
    slot = torch.clamp(pos if slot is None else slot, 0, s_len - 1).long()
    for name, v in new.items():
        v = v.to(cache[name].dtype)
        if ok is not None:
            v = torch.where(ok.reshape(-1, *([1] * (v.dim() - 1))), v, cache[name][bidx, slot])
        cache[name][bidx, slot] = v
    kv = pos.to(torch.int32)
    if ok is not None:
        kv = torch.where(ok, kv, cache["kv_pos"][bidx, slot])
    cache["kv_pos"][bidx, slot] = kv


def attention_decode(p, x: torch.Tensor, pos: torch.Tensor, cache, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, rope_theta: float = 10000.0,
                     window: int | None = None, axes: Axes = SINGLE):
    """One token per sequence. x: (B, 1, d); pos: (B,) integer positions;
    cache: :func:`init_cache`'s, written at ``pos`` in place. Returns
    ``(out (B, 1, d), cache)``. Query head h reads KV head h // group;
    ``n_heads`` and ``n_kv_heads`` are the rank's local heads, and the out
    projection's partial sums are summed over ``axes``' model group. With
    ``axes.sp`` the cache holds this rank's slice of the sequence (slots
    [i·S_loc, (i+1)·S_loc) on sequence shard i): the new KV is written
    only on the shard that owns ``pos``, and the softmax's max, sum and
    weighted values are combined over the data group."""
    b = x.shape[0]
    q, k, v = _qkv(p, x)
    q = rope(q.reshape(b, 1, n_heads, head_dim), pos[:, None], rope_theta)
    k = rope(k.reshape(b, 1, n_kv_heads, head_dim), pos[:, None], rope_theta)
    new = {"k": k[:, 0], "v": v.reshape(b, n_kv_heads, head_dim)}
    if axes.sp is None:
        write_slots(cache, pos, new)
    else:
        slot = pos - axes.sp_index * cache["kv_pos"].shape[1]
        write_slots(cache, pos, new, slot=slot,
                    ok=(slot >= 0) & (slot < cache["kv_pos"].shape[1]))
    qh = q.reshape(b, n_kv_heads, n_heads // n_kv_heads, head_dim).to(torch.float32)
    logits = torch.einsum("bhgd,bshd->bhgs", qh, cache["k"].to(torch.float32))
    logits = logits * f32_scale(head_dim)
    kv_pos = cache["kv_pos"][:, None, None, :]
    now = pos[:, None, None, None]
    mask = kv_pos <= now
    if window is not None:
        mask &= kv_pos > now - window
    logits = torch.where(mask, logits, NEG_INF)
    m = axes.pmax_sp(torch.amax(logits, dim=-1, keepdim=True))
    e = torch.exp(logits - m)
    s = axes.psum_sp(torch.sum(e, dim=-1, keepdim=True))
    acc = axes.psum_sp(torch.einsum("bhgs,bshd->bhgd", e, cache["v"].to(torch.float32)))
    out = (acc / torch.clamp(s, min=1e-30)).reshape(b, 1, n_heads * head_dim)
    return axes.psum_tp(out.to(x.dtype) @ p["wo"].to(x.dtype)), cache
